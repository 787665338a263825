"""Discretized mixture-of-logistics loss (counterpart of
``autovc_tpu/ops/mol.py``'s ``discretized_mix_logistic_loss``): the
WaveRNN's MOL output distribution, 3 x nr_mix logits = nr_mix x (mixture
logit, mean, log scale), scored as the probability mass of the target's
quantisation bin.  The sampler is kernel 1's (``ops/wavernn_kernels``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_SCALE_MIN = float(math.log(1e-14))


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_classes: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN
                                  ) -> torch.Tensor:
    """Mean negative log-likelihood of ``y`` (B, T, 1) in [-1, 1] under the
    discretized MOL ``y_hat`` (B, T, 3 * nr_mix): the bin's mass, the
    one-sided CDF at the +-0.999 edges, and the pdf at the bin centre where
    the mass falls below 1e-5 (``mol.py:19-58``)."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.clamp(y_hat[..., 2 * nr_mix:], min=log_scale_min)

    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - F.softplus(plus_in)        # log CDF at -1 edge
    log_one_minus_cdf_min = -F.softplus(min_in)         # at the +1 edge
    cdf_delta = cdf_plus - cdf_min
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)

    inner_inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - math.log((num_classes - 1) / 2))
    inner = torch.where(y > 0.999, log_one_minus_cdf_min, inner_inner)
    log_probs = torch.where(y < -0.999, log_cdf_plus, inner)

    log_probs = log_probs + F.log_softmax(logit_probs, dim=-1)
    return -torch.mean(torch.logsumexp(log_probs, dim=-1))
