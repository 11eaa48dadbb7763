from repro_torch.data.synthetic import lm_batches, make_batch_for

__all__ = ["lm_batches", "make_batch_for"]
