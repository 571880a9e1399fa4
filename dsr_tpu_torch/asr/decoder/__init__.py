"""Decoders of the port: batched top-K token passing over HCLG graphs, the
dense Viterbi family and the dense general-graph WFST decode."""
