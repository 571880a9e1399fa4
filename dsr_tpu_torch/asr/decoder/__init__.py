"""Decoders of the port: batched top-K token passing over HCLG graphs."""
