"""The query engine: featurizer, host hooks, snippet recovery, the coalesced
rerank path and SearchEngine."""
