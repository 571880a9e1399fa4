"""The parallel layer: device meshes, sharding layouts, the graph-sharded
decoder, sequence- and pipeline-parallel collectives.

Counterpart of `dsr_tpu/parallel/` on `torch.distributed`: one process a
device over a (data, model, subband) `DeviceMesh`, NCCL on the card and
gloo on the CPU, chosen by the device the caller names.
"""

from dsr_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from dsr_tpu_torch.parallel import sharding  # noqa: F401
