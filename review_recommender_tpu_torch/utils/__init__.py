"""Host helpers of the port (jax-free copies; see each module), exported as
the JAX package's `utils/__init__.py` exports them: tokenization, gate
groups and factor, and the numeric primitives."""
from review_recommender_tpu_torch.utils.text import (  # noqa: F401
    COLORS,
    STOP_WORDS,
    SYNONYMS,
    build_gate_groups,
    calculate_gate_factor,
    tokenize_query,
    tokenize_document,
)
from review_recommender_tpu_torch.utils.numerics import (  # noqa: F401
    bayesian_prior,
    cosine_similarity_search,
    l2_normalize,
    minmax_normalize,
    trust_score_from_reviews,
)
