"""Several devices: the hybrid engine over a sharded corpus
(parallel/sharded.py), the counterpart of `review_recommender_tpu/parallel/`,
and dp x tp training over a mesh (parallel/mesh.py, parallel/tp_bert.py),
the counterpart of the JAX trainers' mesh."""
from review_recommender_tpu_torch.parallel.mesh import TrainMesh  # noqa: F401
from review_recommender_tpu_torch.parallel.sharded import ShardedSearchEngine  # noqa: F401
