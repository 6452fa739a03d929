"""The offline data pipeline: ETL, product aggregation, sharded embedding
jobs, index build (`data/pipeline.py:run_full_pipeline`) and the
reference-artifact import, on column tables. Nothing here imports pandas."""
from review_recommender_tpu_torch.data.etl import (  # noqa: F401
    clean_chunk,
    normalize_merge,
    stable_id,
)
from review_recommender_tpu_torch.data.pipeline import (  # noqa: F401
    build_index_from_reviews,
    import_reference_artifacts,
    run_full_pipeline,
)
from review_recommender_tpu_torch.data.prep import build_products, looks_spammy  # noqa: F401
