"""Gaussian-mixture math: counterpart of ``arcflow_tpu/ops/gm``."""

from .gm_ops import (gm_to_mean, gm_to_iso_gaussian, gm_to_gaussian,
                     gm_mul_iso_gaussian, gm_mul_gaussian, gm_mul_gm,
                     gaussian_mul_gaussian, iso_gaussian_mul_iso_gaussian,
                     gm_to_sample, gm_logprob, iso_gaussian_logprob,
                     gm_spectral_logprobs, gm_kl_div, gm_entropy,
                     gm_temperature, gm_transpose_t_first,
                     gm1d_pdf_cdf, gm1d_inverse_cdf,
                     gm_samples_to_gaussian_samples,
                     gaussian_samples_to_gm_samples)

__all__ = [
    'gm_to_mean', 'gm_to_iso_gaussian', 'gm_to_gaussian',
    'gm_mul_iso_gaussian', 'gm_mul_gaussian', 'gm_mul_gm',
    'gaussian_mul_gaussian', 'iso_gaussian_mul_iso_gaussian',
    'gm_to_sample', 'gm_logprob', 'iso_gaussian_logprob',
    'gm_spectral_logprobs', 'gm_kl_div', 'gm_entropy',
    'gm_temperature', 'gm_transpose_t_first',
    'gm1d_pdf_cdf', 'gm1d_inverse_cdf',
    'gm_samples_to_gaussian_samples', 'gaussian_samples_to_gm_samples',
]
