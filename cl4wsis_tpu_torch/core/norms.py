"""The norms the --norm_act flag selects (counterpart of
``cl4wsis_tpu/core/norms.py``), NCHW.

* AIN, activated instance norm: in train mode each sample's spatial
  statistics; the running stats move by the batch mean of those, the
  variance unbiased by n / (n - 1) with n = H * W.
* ABR, activated batch renormalisation: in train mode the batch statistics
  with the scale and shift corrected toward the running stats by
  r = sqrt(var_unbiased + eps) / sqrt(running_var + eps) and
  d = (mean - running_mean) / sqrt(running_var + eps), both without
  gradient. The running stats stay frozen (the JAX module's momentum is
  1.0, upstream's 0.0).

Both are ABN in eval mode, with ABN's parameter and buffer names, float32
statistics, activations and output in the input's dtype.
"""

from __future__ import annotations

import torch

from cl4wsis_tpu_torch.core.abn import ABN, MOMENTUM, update_running


class AIN(ABN):

    def _train_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
        n = x.shape[2] * x.shape[3]
        update_running(self, mean.mean(dim=(0, 2, 3)),
                       var.mean(dim=(0, 2, 3)) * (n / max(n - 1, 1)),
                       MOMENTUM)
        return (xf - mean) * torch.rsqrt(var + self.eps) * \
            self.weight[:, None, None] + self.bias[:, None, None]


class ABR(ABN):

    def _train_norm(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            running_std = torch.sqrt(self.running_var + self.eps)
            r = torch.sqrt(var * (n / max(n - 1, 1)) + self.eps) / running_std
            d = (mean - self.running_mean) / running_std
        w, b = self.weight * r, self.bias + self.weight * d
        inv = torch.rsqrt(var + self.eps) * w
        return (xf - mean[:, None, None]) * inv[:, None, None] + \
            b[:, None, None]


def norm_factory(norm_act: str):
    """abr and iabr map to ABR, ain to AIN, anything else (iabn_sync,
    iabn, ...) to ABN, as in the JAX package."""
    if norm_act in ("abr", "iabr"):
        return ABR
    if norm_act == "ain":
        return AIN
    return ABN
