"""Evaluation harness: IR metrics, benchmark queries and configs, the
method sweep (counterparts of the JAX package's evals/, exported as its
`evals/__init__.py` exports them)."""
from review_recommender_tpu_torch.evals.metrics import (  # noqa: F401
    IRMetrics,
    dcg_at_k,
    evaluate_ranking_methods,
    mrr_score,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)
from review_recommender_tpu_torch.evals.queries import (  # noqa: F401
    BENCHMARK_CONFIGS,
    TEST_QUERIES,
    synthetic_ground_truth,
    validate_ground_truth,
)
