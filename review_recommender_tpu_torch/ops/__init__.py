"""Query-path ops: plain torch and library products for retrieval (exact,
striped and IVF pools; float or int8 corpus) and fusion, CUDA kernels for
the fused attention (ops/attention.py, csrc/mha_fwd.cu) and the
full-corpus BM25 scans (ops/bm25_kernel.py, csrc/bm25_full.cu)."""
