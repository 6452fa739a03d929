"""Corpus sharding: the hybrid engine over a list of devices
(parallel/sharded.py), the counterpart of `review_recommender_tpu/parallel/`."""
from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine  # noqa: F401
