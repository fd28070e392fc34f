"""Flow training losses: pure functions of an outputs dict.

Counterpart of ``arcflow_tpu/diffusion/losses.py`` (``_flatmean``,
``mse_loss``, ``_BaseDiffusionLoss``, ``DiffusionMSELoss``,
``GMFlowNLLLoss``): a per-sample loss with a constant rescale, averaged over
the batch (the reduction every config uses), ``__call__(outputs) -> (loss,
log_info)``, with the per-sample predicted variance in ``log_info`` where
the loss has one. The ArcFlow configs use ``data_info=dict(pred='u_t_pred',
target='u_t')`` and ``rescale_cfg=dict(scale=30)``. The Gaussian NLL
(``DiffusionNLLLoss``, no config of the repo sets it) waits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.gm import gm_logprob
from ..registry import MODULES


def _flatmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims -> (B,)."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    err = torch.square(pred.float() - target.float())
    if weight is not None:
        err = err * weight
    return _flatmean(err)


class _BaseDiffusionLoss:
    """Key remapping (``data_info``) and constant rescale."""

    _default_data_info: Dict[str, str] = {}

    def __init__(self, rescale_mode: str = 'constant',
                 rescale_cfg: Optional[dict] = None,
                 data_info: Optional[dict] = None):
        if rescale_mode != 'constant':
            raise ValueError(f'unsupported rescale_mode {rescale_mode}')
        self.scale = float((rescale_cfg or {}).get('scale', 1.0))
        self.data_info = dict(data_info) if data_info is not None \
            else dict(self._default_data_info)

    def _gather(self, outputs: Dict[str, torch.Tensor]):
        return {k: outputs.get(v) for k, v in self.data_info.items()}

    def per_sample(self, outputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def variance(self, outputs: Dict[str, torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        """Per-sample predicted variance for quartile logging, or None."""
        return None

    def __call__(self, outputs: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        per_sample = self.per_sample(outputs) * self.scale
        log_info = {'per_sample_loss': per_sample.detach()}
        if 'timesteps' in outputs:
            log_info['timesteps'] = outputs['timesteps']
        var = self.variance(outputs)
        if var is not None:
            log_info['per_sample_var'] = var.detach()
        return per_sample.mean(), log_info


@MODULES.register_module()
class DiffusionMSELoss(_BaseDiffusionLoss):
    """0.5 * MSE between ``data_info['pred']`` and ``data_info['target']``."""

    _default_data_info = dict(pred='eps_t_pred', target='noise')

    def per_sample(self, outputs):
        d = self._gather(outputs)
        weight = outputs.get(self.data_info.get('weight')) \
            if 'weight' in self.data_info else outputs.get('weight')
        return 0.5 * mse_loss(d['pred'], d['target'], weight=weight)


@MODULES.register_module()
class GMFlowNLLLoss(_BaseDiffusionLoss):
    """Negative log-likelihood of the target under a Gaussian-mixture
    prediction, per channel: means (B, K, H, W, C), logstds, logweights
    (B, K, H, W, 1); target (B, H, W, C)."""

    _default_data_info = dict(pred_means='means', target='u_t',
                              pred_logstds='logstds',
                              pred_logweights='logweights')

    def per_sample(self, outputs):
        d = self._gather(outputs)
        num_channels = d['pred_means'].shape[-1]
        gm = dict(means=d['pred_means'], logstds=d['pred_logstds'],
                  logweights=d['pred_logweights'])
        logprob, _ = gm_logprob(gm, d['target'][:, None])   # (B, 1, H, W)
        loss = -logprob.squeeze(1) / num_channels           # (B, H, W)
        weight = outputs.get('weight')
        if weight is not None:
            loss = loss * weight
        return _flatmean(loss)

    def variance(self, outputs):
        d = self._gather(outputs)
        w = torch.exp(d['pred_logweights'])
        mean = (w * d['pred_means']).sum(dim=1, keepdim=True)
        var = (w * ((d['pred_means'] - mean).square()
                    + torch.exp(2.0 * d['pred_logstds']))).sum(dim=1)
        return _flatmean(var)
