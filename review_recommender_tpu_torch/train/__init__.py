"""Training: contrastive bi-encoder, pointwise cross-encoder and MLM
pretraining, with the optax chain of the JAX trainers (train/optim.py),
on one device or over a dp x tp mesh (mesh=TrainMesh(...),
parallel/mesh.py; the tp layout in parallel/tp_bert.py)."""
from review_recommender_tpu_torch.train.contrastive import (  # noqa: F401
    ContrastiveTrainer,
    TrainConfig,
    make_pair_batch,
    param_specs,
    shard_params,
)
from review_recommender_tpu_torch.train.cross_encoder import (  # noqa: F401
    CrossEncoderTrainer,
    CrossTrainConfig,
    make_triple_batch,
    train_crossencoder,
)
from review_recommender_tpu_torch.train.data import (  # noqa: F401
    mine_pairs,
    mine_triples,
    train_biencoder,
)
from review_recommender_tpu_torch.train.mlm import (  # noqa: F401
    MLMTrainConfig,
    MLMTrainer,
    init_mlm,
    make_mlm_batch,
    pretrain_mlm,
)
