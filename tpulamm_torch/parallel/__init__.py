"""Tensor / data parallel serving on a (dp, tp) mesh and its multi-process
runs (counterpart of tpulamm.parallel)."""
