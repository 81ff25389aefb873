"""Variational autoencoder layer (port of
deeplearning4j_tpu/nn/layers/variational.py).

A pretrain layer: encoder MLP -> (mean, log-var) -> reparameterized
sample -> decoder MLP -> a pluggable reconstruction distribution; the
unsupervised loss is -ELBO. The supervised forward outputs the latent
mean. The reparameterization's eps comes from `Layer.draw` (a function
of (key, shape) alone), sample ``s`` from key fold_in(key, s).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, fold_in
from deeplearning4j_tpu_torch.nn.weights import init_weights

Tensor = torch.Tensor


@register
@dataclass
class VariationalAutoencoder(BaseLayer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None          # latent size
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    # "gaussian" | "bernoulli" | "exponential", or a composite: a sequence
    # of (feature_count, kind) pairs modeling successive feature slices
    reconstruction_distribution: Any = "gaussian"
    pzx_activation: str = "identity"
    num_samples: int = 1

    def is_pretrain_layer(self) -> bool:
        return True

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        raise ValueError(f"VAE cannot take input {input_type}")

    def _components(self) -> Tuple[Tuple[int, str], ...]:
        """Normalize to ((feature_count, kind), ...); a plain string kind
        covers all n_in features."""
        rd = self.reconstruction_distribution
        if isinstance(rd, str):
            return ((self.n_in, rd),)
        comps = tuple((int(n), str(k)) for n, k in rd)
        total = sum(n for n, _ in comps)
        if total != self.n_in:
            raise ValueError(
                f"Composite reconstruction distribution covers {total} "
                f"features but n_in={self.n_in}")
        return comps

    @staticmethod
    def _params_per_feature(kind: str) -> int:
        return 1 if kind == "bernoulli" else 2

    def _recon_out_size(self) -> int:
        return sum(n * self._params_per_feature(k)
                   for n, k in self._components())

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        params: Dict[str, Tensor] = {}
        scheme = self.weight_init or "xavier"

        def dense(w_name, b_name, n_in, n_out):
            params[w_name] = init_weights(gen, (n_in, n_out), n_in, n_out,
                                          scheme, self.dist, dtype, device)
            params[b_name] = torch.zeros((n_out,), dtype=dtype,
                                         device=device)

        sizes_enc = [self.n_in, *self.encoder_layer_sizes]
        for i in range(len(sizes_enc) - 1):
            dense(f"eW{i}", f"eb{i}", sizes_enc[i], sizes_enc[i + 1])
        dense("muW", "mub", sizes_enc[-1], self.n_out)
        dense("lvW", "lvb", sizes_enc[-1], self.n_out)
        sizes_dec = [self.n_out, *self.decoder_layer_sizes]
        for i in range(len(sizes_dec) - 1):
            dense(f"dW{i}", f"db{i}", sizes_dec[i], sizes_dec[i + 1])
        dense("xW", "xb", sizes_dec[-1], self._recon_out_size())
        return params

    def weight_param_keys(self):
        keys = ["muW", "lvW", "xW"]
        keys += [f"eW{i}" for i in range(len(self.encoder_layer_sizes))]
        keys += [f"dW{i}" for i in range(len(self.decoder_layer_sizes))]
        return tuple(keys)

    def _encode(self, params, x):
        act = get_activation(self.activation or "tanh")
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"eW{i}"]) + params[f"eb{i}"])
        mu = torch.matmul(h, params["muW"]) + params["mub"]
        mu = get_activation(self.pzx_activation)(mu)
        logvar = torch.matmul(h, params["lvW"]) + params["lvb"]
        return mu, logvar

    def _decode(self, params, z):
        act = get_activation(self.activation or "tanh")
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"dW{i}"]) + params[f"db{i}"])
        return torch.matmul(h, params["xW"]) + params["xb"]

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        mu, _ = self._encode(params, x)
        return mu, state

    @staticmethod
    def _component_log_prob(kind: str, raw, x):
        """Per-example log p(x|raw) for one distribution over one feature
        slice; ``raw`` carries params_per_feature(kind) params per
        feature."""
        eps = 1e-7
        if kind == "bernoulli":
            p = torch.clamp(torch.sigmoid(raw), eps, 1 - eps)
            return torch.sum(x * torch.log(p) + (1 - x) * torch.log(1 - p),
                             dim=-1)
        if kind == "gaussian":
            mean, logvar = torch.chunk(raw, 2, dim=-1)
            var = torch.exp(logvar)
            return torch.sum(
                -0.5 * (math.log(2 * math.pi) + logvar
                        + (x - mean) ** 2 / var), dim=-1)
        if kind == "exponential":
            # rate = exp(gamma); log p = gamma - rate*x
            gamma, _ = torch.chunk(raw, 2, dim=-1)
            return torch.sum(gamma - torch.exp(gamma) * x, dim=-1)
        raise ValueError(f"Unknown reconstruction distribution '{kind}'")

    def _recon_log_prob(self, recon_raw, x):
        total = 0.0
        x_off = raw_off = 0
        for n, kind in self._components():
            width = n * self._params_per_feature(kind)
            total = total + self._component_log_prob(
                kind, recon_raw[..., raw_off:raw_off + width],
                x[..., x_off:x_off + n])
            x_off += n
            raw_off += width
        return total

    def _sample_log_prob(self, params, x, mu, logvar, key, s):
        eps = self.draw("normal", fold_in(key, s), mu.shape,
                        mu.device).to(mu.dtype)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self._recon_log_prob(self._decode(params, z), x)

    def pretrain_loss(self, params, x, key):
        """-ELBO = -E[log p(x|z)] + KL(q(z|x) || N(0,1))."""
        mu, logvar = self._encode(params, x)
        total = 0.0
        for s in range(self.num_samples):
            total = total + self._sample_log_prob(params, x, mu, logvar,
                                                  key, s)
        log_px = total / self.num_samples
        kl = 0.5 * torch.sum(torch.exp(logvar) + mu ** 2 - 1.0 - logvar,
                             dim=-1)
        return torch.mean(kl - log_px)

    def reconstruction_prob(self, params, x, key, num_samples=None):
        """Importance-sampled reconstruction log-probability."""
        n = num_samples or self.num_samples
        mu, logvar = self._encode(params, x)
        logps = [self._sample_log_prob(params, x, mu, logvar, key, s)
                 for s in range(n)]
        return torch.logsumexp(torch.stack(logps), dim=0) - math.log(n)
