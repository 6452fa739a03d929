"""Topic analytics on the card and the host: spherical k-means and density
clustering (an exact kNN graph on the card), TF-IDF and LLM topic naming,
aspect metrics and resume-safe topic cards; the JAX package's
`topics/__init__.py` exports, less `knn_graph_sharded` (ROADMAP Queue 1
item 12)."""
from review_recommender_tpu_torch.topics.cards import generate_topic_cards, pick_quotes  # noqa: F401
from review_recommender_tpu_torch.topics.cluster import kmeans_sanity, spherical_kmeans  # noqa: F401
from review_recommender_tpu_torch.topics.density import density_cluster, knn_graph  # noqa: F401
from review_recommender_tpu_torch.topics.naming import (  # noqa: F401
    aspect_metrics,
    map_label_to_aspect,
    name_topics,
    name_topics_llm,
    tfidf_topic_terms,
)
