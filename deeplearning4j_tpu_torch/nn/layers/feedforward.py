"""Feed-forward layers (port of deeplearning4j_tpu/nn/layers/feedforward.py).

`DenseLayer` (which `OutputLayer` extends), `EmbeddingLayer`, and the
pretraining layers `AutoEncoder` (denoising) and `RBM` (CD-k). The dense
forward is a matmul on the trailing axis, so it also runs timestep-wise
on [B, T, F] sequences. The pretraining layers take every random draw
(corruption, Gibbs samples) from `Layer.draw`, a function of (key,
shape) alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf import inputs as it
from deeplearning4j_tpu_torch.nn.conf.serde import register
from deeplearning4j_tpu_torch.nn.layers.base import BaseLayer, fold_in
from deeplearning4j_tpu_torch.nn.weights import init_weights

Tensor = torch.Tensor


@register
@dataclass
class DenseLayer(BaseLayer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        if isinstance(input_type, it.InputTypeRecurrent):
            # dense applied per-timestep
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.recurrent(self.n_out,
                                          input_type.time_series_length)
        raise ValueError(f"{type(self).__name__} cannot take input "
                         f"{input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in, self.n_out,
                         self.weight_init or "xavier", self.dist, dtype,
                         device)
        b = torch.full((self.n_out,), float(self.bias_init), dtype=dtype,
                       device=device)
        return {"W": w, "b": b}

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        z = self.pre_output(params, x)
        return get_activation(self.activation or "sigmoid")(z), state

    def pre_output(self, params, x):
        return torch.matmul(x, params["W"]) + params["b"]


@register
@dataclass
class EmbeddingLayer(BaseLayer):
    """Index -> vector lookup: integer indices [B] or [B, 1] gather rows
    of W; a one-hot float input [B, n_in] multiplies W (the same
    function)."""
    n_in: Optional[int] = None   # vocabulary size
    n_out: Optional[int] = None  # embedding dim

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        raise ValueError(f"EmbeddingLayer cannot take input {input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        return DenseLayer.init_params(self, gen, dtype, device)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        if x.is_floating_point() and x.ndim >= 2 \
                and x.shape[-1] == self.n_in:
            z = torch.matmul(x, params["W"]) + params["b"]
        else:
            idx = x.long()
            if idx.ndim >= 2 and idx.shape[-1] == 1:
                idx = idx[..., 0]
            z = params["W"][idx] + params["b"]
        return get_activation(self.activation or "identity")(z), state


@register
@dataclass
class AutoEncoder(BaseLayer):
    """Denoising autoencoder pretrain layer. The supervised forward is
    encode(); pretraining reconstructs corrupted input (see
    MultiLayerNetwork.pretrain)."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    corruption_level: float = 0.3
    sparsity: float = 0.0

    def is_pretrain_layer(self) -> bool:
        return True

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        raise ValueError(f"AutoEncoder cannot take input {input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        p = DenseLayer.init_params(self, gen, dtype, device)
        p["vb"] = torch.zeros((self.n_in,), dtype=dtype, device=device)
        return p

    def encode(self, params, x):
        act = get_activation(self.activation or "sigmoid")
        return act(torch.matmul(x, params["W"]) + params["b"])

    def decode(self, params, h):
        act = get_activation(self.activation or "sigmoid")
        return act(torch.matmul(h, params["W"].T) + params["vb"])

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        return self.encode(params, x), state

    def pretrain_loss(self, params, x, key):
        """Reconstruction cross-entropy on corrupted input: each input
        unit is kept with probability 1 - corruption_level."""
        if self.corruption_level > 0 and key is not None:
            keep = self.draw("uniform", key, x.shape, x.device) \
                < 1.0 - self.corruption_level
            corrupted = torch.where(keep, x, torch.zeros_like(x))
        else:
            corrupted = x
        recon = self.decode(params, self.encode(params, corrupted))
        eps = 1e-7
        recon = torch.clamp(recon, eps, 1 - eps)
        return -torch.mean(torch.sum(
            x * torch.log(recon) + (1 - x) * torch.log(1 - recon), dim=-1))


@register
@dataclass
class RBM(BaseLayer):
    """Restricted Boltzmann machine pretrain layer (CD-k contrastive
    divergence, binary or gaussian units). CD-1 is autograd over the
    free-energy difference F(v_data) - F(v_sample) with the Gibbs sample
    detached: the gradient of that surrogate is the CD update."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    visible_unit: str = "binary"   # 'binary' | 'gaussian'
    hidden_unit: str = "binary"
    k: int = 1                     # CD-k Gibbs steps

    def is_pretrain_layer(self) -> bool:
        return True

    def update_input_type(self, input_type):
        if isinstance(input_type, it.InputTypeFeedForward):
            if self.n_in is None:
                self.n_in = input_type.size
            return it.InputType.feed_forward(self.n_out)
        raise ValueError(f"RBM cannot take input {input_type}")

    def init_params(self, gen, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init or "xavier",
                         self.dist, dtype, device)
        return {"W": w,
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device),
                "vb": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def _prop_up(self, params, v):
        return torch.sigmoid(torch.matmul(v, params["W"]) + params["b"])

    def _prop_down(self, params, h):
        mean = torch.matmul(h, params["W"].T) + params["vb"]
        return mean if self.visible_unit == "gaussian" \
            else torch.sigmoid(mean)

    def apply(self, params, state, x, *, train=False, key=None, mask=None
              ) -> Tuple[Tensor, Dict]:
        # supervised forward: hidden activation probabilities
        return self._prop_up(params, x), state

    def _free_energy(self, params, v):
        """F(v) = -v.vb - sum softplus(vW + b) (binary visible); gaussian
        visible units add the quadratic term."""
        wx_b = torch.matmul(v, params["W"]) + params["b"]
        hidden = torch.sum(torch.nn.functional.softplus(wx_b), dim=-1)
        if self.visible_unit == "gaussian":
            vis = 0.5 * torch.sum((v - params["vb"]) ** 2, dim=-1)
            return vis - hidden
        return -torch.matmul(v, params["vb"]) - hidden

    def pretrain_loss(self, params, x, key):
        """Gibbs step ``s`` samples the hidden units from draw key
        fold_in(key, 2s) and the visible ones from fold_in(key, 2s + 1),
        each a Bernoulli: uniform < p."""
        v = x
        for step in range(self.k):
            h_prob = self._prop_up(params, v)
            h = ((self.draw("uniform", fold_in(key, 2 * step),
                            h_prob.shape, x.device) < h_prob).to(x.dtype)
                 if self.hidden_unit == "binary" else h_prob)
            v = self._prop_down(params, h)
            if self.visible_unit == "binary":
                v = (self.draw("uniform", fold_in(key, 2 * step + 1),
                               v.shape, x.device) < v).to(x.dtype)
        v_model = v.detach()
        return torch.mean(self._free_energy(params, x)
                          - self._free_energy(params, v_model))
