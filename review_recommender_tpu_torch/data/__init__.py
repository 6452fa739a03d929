"""The offline data path: a reference deployment's artifacts imported into
an index bundle (`data/pipeline.py`). The raw-review pipeline of the JAX
package's `data/` (ETL, aggregation, embedding jobs) is ROADMAP Queue 1
item 19. Nothing here imports pandas."""
from review_recommender_tpu_torch.data.pipeline import import_reference_artifacts  # noqa: F401
