"""Device-side compute ops: forward model, chi-square loss, batched lstsq."""

from .loss import (
    chunked_loss,
    chunked_loss_sum_regularized,
    data_model,
    fg_model,
    fg_model_all_chunks,
    gain_products,
    mse,
)
from .lstsq import init_coeffs_chunk

__all__ = [
    "fg_model",
    "gain_products",
    "data_model",
    "mse",
    "chunked_loss",
    "chunked_loss_sum_regularized",
    "fg_model_all_chunks",
    "init_coeffs_chunk",
]
