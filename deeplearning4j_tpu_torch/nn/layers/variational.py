"""Variational autoencoder layer and reconstruction distributions.

The port of the JAX package's ``nn/layers/variational.py`` (reference:
deeplearning4j-nn/.../nn/layers/variational/VariationalAutoencoder.java:51
and nn/conf/layers/variational/: Gaussian, Bernoulli, Exponential and
Composite reconstruction distributions, LossFunctionWrapper). The whole
ELBO (encoder MLP, reparameterized sample, decoder MLP, reconstruction
log-likelihood and KL) is one function differentiated by
``torch.autograd``. Used supervised, the layer outputs the latent mean.

Noise: the JAX package draws each sample's epsilon with
``jax.random.normal(fold_in(key, s))``, which no torch generator can
reproduce. The port draws it from a ``torch.Generator``, and every
function that samples also takes ``eps`` (a sequence of ``num_samples``
tensors of the latent mean's shape) so a caller can feed both packages
the same noise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.inputs import FeedForwardType, InputType
from deeplearning4j_tpu_torch.nn.layers.base import (FeedForwardLayer,
                                                     LayerContext)
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.utils.serde import register_serializable

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class ReconstructionDistribution:
    """SPI: conf/layers/variational/ReconstructionDistribution.java."""

    def params_per_feature(self) -> int:
        raise NotImplementedError

    def log_prob(self, x: torch.Tensor, dist_params: torch.Tensor
                 ) -> torch.Tensor:
        """Per-example log p(x|params); dist_params has n_in *
        params_per_feature features."""
        raise NotImplementedError

    def mean(self, dist_params: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@register_serializable
@dataclasses.dataclass(frozen=True)
class GaussianReconstructionDistribution(ReconstructionDistribution):
    """N(mu, sigma^2) per feature; params = [mu | log(sigma^2)]."""
    activation: Activation = Activation.IDENTITY

    def params_per_feature(self) -> int:
        return 2

    def _split(self, dist_params):
        n = dist_params.shape[-1] // 2
        mu = self.activation.apply(dist_params[..., :n])
        log_var = dist_params[..., n:]
        return mu, log_var

    def log_prob(self, x, dist_params):
        mu, log_var = self._split(dist_params)
        inv_var = torch.exp(-log_var)
        ll = -_HALF_LOG_2PI - 0.5 * log_var \
            - 0.5 * torch.square(x - mu) * inv_var
        return torch.sum(ll, dim=-1)

    def mean(self, dist_params):
        return self._split(dist_params)[0]


@register_serializable
@dataclasses.dataclass(frozen=True)
class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli(p) per feature, p through sigmoid by default."""
    activation: Activation = Activation.SIGMOID

    def params_per_feature(self) -> int:
        return 1

    def log_prob(self, x, dist_params):
        p = torch.clamp(self.activation.apply(dist_params), 1e-7, 1 - 1e-7)
        ll = x * torch.log(p) + (1.0 - x) * torch.log1p(-p)
        return torch.sum(ll, dim=-1)

    def mean(self, dist_params):
        return self.activation.apply(dist_params)


@register_serializable
@dataclasses.dataclass(frozen=True)
class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Exp(lambda) per feature; the network emits gamma = log(lambda)."""
    activation: Activation = Activation.IDENTITY

    def params_per_feature(self) -> int:
        return 1

    def log_prob(self, x, dist_params):
        gamma = self.activation.apply(dist_params)
        lam = torch.exp(gamma)
        return torch.sum(gamma - lam * x, dim=-1)

    def mean(self, dist_params):
        return torch.exp(-self.activation.apply(dist_params))


@register_serializable
@dataclasses.dataclass(frozen=True)
class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Different distributions over contiguous feature slices;
    ``components`` = tuple of (n_features, distribution)."""
    components: Tuple = ()

    def params_per_feature(self) -> int:
        raise TypeError("composite: use total_params(n_in) slicing")

    def total_params(self) -> int:
        return sum(n * d.params_per_feature() for n, d in self.components)

    def total_features(self) -> int:
        return sum(n for n, _ in self.components)

    def log_prob(self, x, dist_params):
        ll = None
        xo = po = 0
        for n, dist in self.components:
            xs = x[..., xo:xo + n]
            ps = dist_params[..., po:po + n * dist.params_per_feature()]
            part = dist.log_prob(xs, ps)
            ll = part if ll is None else ll + part
            xo += n
            po += n * dist.params_per_feature()
        return ll

    def mean(self, dist_params):
        outs = []
        po = 0
        for n, dist in self.components:
            ps = dist_params[..., po:po + n * dist.params_per_feature()]
            outs.append(dist.mean(ps))
            po += n * dist.params_per_feature()
        return torch.cat(outs, dim=-1)


@register_serializable
@dataclasses.dataclass(frozen=True)
class LossFunctionWrapper(ReconstructionDistribution):
    """A plain loss function as an (improper) reconstruction measure;
    without one, the per-example squared error."""
    loss: object = None
    activation: Activation = Activation.IDENTITY

    def params_per_feature(self) -> int:
        return 1

    def log_prob(self, x, dist_params):
        out = self.activation.apply(dist_params)
        if self.loss is None:
            per = torch.sum(torch.square(x - out), dim=-1)
        else:
            per = self.loss(x, out)      # a LossFunction is callable
        return -per

    def mean(self, dist_params):
        return self.activation.apply(dist_params)


def _mlp_init(generator, sizes, weight_init, dt):
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"W{i}"] = weight_init.init(generator, (a, b), a, b, dt)
        params[f"b{i}"] = torch.zeros((b,), dtype=dt)
    return params


def _mlp_apply(params, x, activation, n_layers):
    for i in range(n_layers):
        x = activation.apply(torch.matmul(x, params[f"W{i}"])
                             + params[f"b{i}"])
    return x


@register_serializable
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(FeedForwardLayer):
    """VAE as a layer (conf/layers/variational/VariationalAutoencoder.java).
    ``n_out`` is the latent size. The supervised forward outputs the
    latent mean; ``pretrain_loss`` is the negative ELBO that
    ``MultiLayerNetwork.pretrain`` minimizes."""
    encoder_layer_sizes: Tuple[int, ...] = (256,)
    decoder_layer_sizes: Tuple[int, ...] = (256,)
    reconstruction_distribution: ReconstructionDistribution = \
        dataclasses.field(
            default_factory=GaussianReconstructionDistribution)
    pzx_activation: Activation = Activation.IDENTITY
    num_samples: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return FeedForwardType(self.n_out)

    @property
    def supports_pretrain(self) -> bool:
        return True

    def _dist_param_count(self, n_in: int) -> int:
        d = self.reconstruction_distribution
        if isinstance(d, CompositeReconstructionDistribution):
            return d.total_params()
        return n_in * d.params_per_feature()

    def initialize(self, generator, input_type):
        n_in = self.resolved_n_in(input_type)
        dt = self.param_dtype()
        enc_sizes = (n_in,) + tuple(self.encoder_layer_sizes)
        dec_sizes = (self.n_out,) + tuple(self.decoder_layer_sizes)
        last_enc, last_dec = enc_sizes[-1], dec_sizes[-1]
        n_dist = self._dist_param_count(n_in)
        wi = self.weight_init
        return {
            "enc": _mlp_init(generator, enc_sizes, wi, dt),
            "Wmu": wi.init(generator, (last_enc, self.n_out), last_enc,
                           self.n_out, dt),
            "bmu": torch.zeros((self.n_out,), dtype=dt),
            "Wlv": wi.init(generator, (last_enc, self.n_out), last_enc,
                           self.n_out, dt),
            "blv": torch.zeros((self.n_out,), dtype=dt),
            "dec": _mlp_init(generator, dec_sizes, wi, dt),
            "Wout": wi.init(generator, (last_dec, n_dist), last_dec, n_dist,
                            dt),
            "bout": torch.zeros((n_dist,), dtype=dt),
        }

    # ---- supervised forward: latent mean ---------------------------------
    def apply(self, params, state, x, ctx: LayerContext):
        x = self.maybe_dropout(x, ctx)
        h = _mlp_apply(params["enc"], x, self.activation,
                       len(self.encoder_layer_sizes))
        mu = torch.matmul(h, params["Wmu"]) + params["bmu"]
        return self.pzx_activation.apply(mu), state

    # ---- unsupervised: ELBO ----------------------------------------------
    def _encode(self, params, x):
        h = _mlp_apply(params["enc"], x, self.activation,
                       len(self.encoder_layer_sizes))
        mu = torch.matmul(h, params["Wmu"]) + params["bmu"]
        log_var = torch.matmul(h, params["Wlv"]) + params["blv"]
        return self.pzx_activation.apply(mu), log_var

    def _decode(self, params, z):
        d = _mlp_apply(params["dec"], z, self.activation,
                       len(self.decoder_layer_sizes))
        return torch.matmul(d, params["Wout"]) + params["bout"]

    @staticmethod
    def _noise(mu, n, generator, eps):
        """``n`` standard normal draws of mu's shape: the caller's ``eps``,
        else from ``generator``."""
        if eps is not None:
            if len(eps) != n:
                raise ValueError(f"eps: {len(eps)} samples, expected {n}")
            return [torch.as_tensor(e, dtype=mu.dtype, device=mu.device)
                    for e in eps]
        return [torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                            device=mu.device) for _ in range(n)]

    def pretrain_loss(self, params, x, generator=None,
                      eps: Optional[Sequence[torch.Tensor]] = None
                      ) -> torch.Tensor:
        """Negative ELBO, averaged over the batch (and ``num_samples``
        Monte Carlo samples of z): VariationalAutoencoder
        .computeGradientAndScore."""
        mu, log_var = self._encode(params, x)
        kl = -0.5 * torch.sum(1.0 + log_var - torch.square(mu)
                              - torch.exp(log_var), dim=-1)
        total_ll = 0.0
        for e in self._noise(mu, self.num_samples, generator, eps):
            z = mu + torch.exp(0.5 * log_var) * e
            total_ll = total_ll + self.reconstruction_distribution.log_prob(
                x, self._decode(params, z))
        recon_ll = total_ll / self.num_samples
        return torch.mean(kl - recon_ll)

    # ---- reference API extras -------------------------------------------
    def reconstruct(self, params, x):
        """x -> encode (mean) -> decode -> the distribution's mean."""
        mu, _ = self._encode(params, x)
        return self.reconstruction_distribution.mean(self._decode(params, mu))

    def generate_at_mean_given_z(self, params, z):
        return self.reconstruction_distribution.mean(self._decode(params, z))

    def reconstruction_log_probability(self, params, x, generator=None,
                                       num_samples: int = 5,
                                       eps: Optional[Sequence[torch.Tensor]]
                                       = None) -> torch.Tensor:
        """Monte Carlo estimate of log p(x) (reconstructionLogProbability)
        by importance sampling at q(z|x)."""
        mu, log_var = self._encode(params, x)
        lls = []
        for e in self._noise(mu, num_samples, generator, eps):
            z = mu + torch.exp(0.5 * log_var) * e
            log_p_xz = self.reconstruction_distribution.log_prob(
                x, self._decode(params, z))
            log_p_z = torch.sum(-_HALF_LOG_2PI - 0.5 * torch.square(z),
                                dim=-1)
            log_q = torch.sum(-_HALF_LOG_2PI - 0.5 * log_var
                              - 0.5 * torch.square(e), dim=-1)
            lls.append(log_p_xz + log_p_z - log_q)
        return torch.logsumexp(torch.stack(lls), dim=0) - math.log(
            float(num_samples))
