"""Clustering of unit embeddings (the IVF pool's k-means)."""
