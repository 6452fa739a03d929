"""Index schema and the build helpers the query path needs."""
