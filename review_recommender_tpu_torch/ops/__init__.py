"""Query-path ops: plain torch for retrieval and fusion, a CUDA kernel for
the fused attention (ops/attention.py, csrc/mha_fwd.cu)."""
