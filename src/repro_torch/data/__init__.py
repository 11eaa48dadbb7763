from repro_torch.data.synthetic import (
    cifar_like_batches,
    classification_batches,
    lm_batches,
    make_batch_for,
)

__all__ = ["lm_batches", "classification_batches", "cifar_like_batches", "make_batch_for"]
