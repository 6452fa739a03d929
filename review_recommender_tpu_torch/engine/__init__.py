"""The query engine: featurizer, host hooks, SearchEngine.run_search."""
