"""Training layer: jitted trainer harness + the learner families."""

from nlsh_jax.train.base import Trainer, TrainState  # noqa: F401
from nlsh_jax.train.triplet import TripletTrainer, triplet_loss  # noqa: F401
from nlsh_jax.train.siamese import SiameseTrainer, contrastive_loss  # noqa: F401
from nlsh_jax.train.proposed import ProposedTrainer  # noqa: F401
from nlsh_jax.train.ae import AETrainer  # noqa: F401
from nlsh_jax.train.vqvae import VQVAETrainer  # noqa: F401
from nlsh_jax.train.hnsw import HNSWBaseline  # noqa: F401
from nlsh_jax.train.multitable import MultiTableTrainer  # noqa: F401

# reference-compatible aliases (nlsh/trainers/__init__.py:1-13)
AE = AETrainer
VQVAE = VQVAETrainer
HierarchicalNavigableSmallWorldGraph = HNSWBaseline
