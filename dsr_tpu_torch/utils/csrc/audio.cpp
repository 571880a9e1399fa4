// The port's native audio library: RIFF/WAVE read and write and the
// threaded sample streamer (wavio.cpp) with the batched corpus loader
// (loader.cpp), which calls wavio's readers.  Built as one translation
// unit, so the loader's calls resolve inside the library
// (dsr_tpu_torch/ops/cuda/build.py hashes both included files).
#include "wavio.cpp"
#include "loader.cpp"
