"""Tensor / data parallel serving and training on a (dp, tp) mesh, the
GPipe pipeline, and their multi-process runs (counterpart of
tpulamm.parallel)."""
