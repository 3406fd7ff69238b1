"""Row sampling strategies: bagging and GOSS.

Port of ``lightgbm_tpu/models/sample_strategy.py`` (ref:
include/LightGBM/sample_strategy.h:24 factory, src/boosting/bagging.hpp:15
BaggingSampleStrategy, src/boosting/goss.hpp:19 GOSSStrategy).

Where the reference produces a permuted index array (``bag_data_indices_``)
fed to DataPartition, a strategy here gives per-row vectors that the engine
multiplies into (grad, hess, count) before the histogram pass: every
physical row stays in the tree's partition, an out-of-bag row with zero
mass. ``weight`` carries GOSS's small-gradient amplification (1-a)/b;
``selected`` is the 0/1 membership that becomes the histograms' count
channel, so ``min_data_in_leaf`` keeps its bagged-count meaning.

The host samplers draw with numpy's ``default_rng(bagging_seed)`` in the
JAX package's order, so a run on the card draws the masks a CPU run (and
the JAX package) draws. ``BaggingStrategy.sample_dev`` is the sync-path
half of ``tpu_device_bagging``: per-row uniforms from the threefry chain
of ``utils/prng.py``, drawn on the training device. ``GOSSStrategy.
sample_dev`` is asynchronous boosting's GOSS draw, all of it on the
training device from the same chain.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils import log, prng


class SampleStrategy:
    """Base: no sampling."""

    # whether sample() reads grad/hess: bagging decides from its RNG
    # alone, so the engine skips the [K, N] device->host read for it
    needs_grad = False

    def __init__(self, config: Config, num_data: int,
                 num_tree_per_iteration: int = 1):
        self.config = config
        self.num_data = num_data
        self.num_tree_per_iteration = num_tree_per_iteration

    def reset_config(self, config: Config) -> None:
        self.config = config

    def is_hessian_change(self) -> bool:
        """Whether the sample rescales the hessians (GOSS amplifies the
        rows it keeps at random)."""
        return False

    def sample(self, it: int, grad: Optional[np.ndarray] = None,
               hess: Optional[np.ndarray] = None
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Return (selected[N] 0/1 f32, weight[N] f32) or None for no-op."""
        return None

    def sample_dev(self, it: int, key, device
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The sample drawn on the device, or None: the host draws."""
        return None

    @staticmethod
    def create(config: Config, num_data: int, num_tree_per_iteration: int,
               metadata=None) -> "SampleStrategy":
        """ref: sample_strategy.cpp SampleStrategy::CreateSampleStrategy."""
        if str(config.data_sample_strategy).lower() == "goss":
            return GOSSStrategy(config, num_data, num_tree_per_iteration)
        return BaggingStrategy(config, num_data, num_tree_per_iteration,
                               metadata)


class BaggingStrategy(SampleStrategy):
    """ref: bagging.hpp:15. Re-samples every ``bagging_freq`` iterations;
    balanced bagging (pos/neg fractions, every iteration even with
    ``bagging_freq=0``) and query-level bagging."""

    def __init__(self, config: Config, num_data: int,
                 num_tree_per_iteration: int = 1, metadata=None):
        super().__init__(config, num_data, num_tree_per_iteration)
        self.rng = np.random.default_rng(config.bagging_seed)
        self.metadata = metadata
        self._cached: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._dev_cached = None
        self.balanced = (
            config.pos_bagging_fraction < 1.0 or
            config.neg_bagging_fraction < 1.0)
        self.need_bagging = (
            (config.bagging_freq > 0 and config.bagging_fraction < 1.0)
            or self.balanced)
        if self.need_bagging:
            log.info("Using bagging, bagging_fraction="
                     f"{config.bagging_fraction}")

    def sample_dev(self, it: int, key, device
                   ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """``tpu_device_bagging`` (ref: the JAX package's sample_dev,
        models/sample_strategy.py:81-114): each row kept with
        probability ``bagging_fraction`` from the uniforms of
        ``fold_in(key, it - it % freq)``, so the mask is the same over a
        ``bagging_freq`` window; the row of the smallest uniform is
        always kept, so no bag is empty. The fraction is approximate,
        where the host sampler takes an exact count. None (the host
        sampler serves) when the option is off and for the balanced and
        by-query variants. Returns (selected, selected) f32 tensors on
        ``device``."""
        cfg = self.config
        if (not cfg.tpu_device_bagging or not self.need_bagging or
                self.balanced or cfg.bagging_by_query):
            return None
        freq = max(cfg.bagging_freq, 1)
        kit = it - it % freq
        if self._dev_cached is not None and self._dev_cached[0] == kit:
            return self._dev_cached[1]
        u = prng.uniform(prng.fold_in(key, kit), self.num_data, device)
        sel = u < torch.tensor(cfg.bagging_fraction, dtype=torch.float32,
                               device=device)
        sel[torch.argmin(u)] = True
        sel = sel.to(torch.float32)
        self._dev_cached = (kit, (sel, sel))
        return sel, sel

    def sample(self, it, grad=None, hess=None):
        cfg = self.config
        if not self.need_bagging:
            return None
        freq = max(cfg.bagging_freq, 1)
        if it % freq != 0 and self._cached is not None:
            return self._cached
        n = self.num_data
        if self.balanced and self.metadata is not None and \
                self.metadata.label is not None:
            pos = self.metadata.label > 0
            sel = np.zeros(n, np.float32)
            sel[pos] = (self.rng.random(int(pos.sum())) <
                        cfg.pos_bagging_fraction)
            sel[~pos] = (self.rng.random(int((~pos).sum())) <
                         cfg.neg_bagging_fraction)
        elif cfg.bagging_by_query and self.metadata is not None and \
                self.metadata.query_boundaries is not None:
            qb = self.metadata.query_boundaries
            take = self.rng.random(len(qb) - 1) < cfg.bagging_fraction
            sel = np.zeros(n, np.float32)
            for q in np.flatnonzero(take):
                sel[qb[q]:qb[q + 1]] = 1.0
        else:
            cnt = max(1, int(n * cfg.bagging_fraction))
            idx = self.rng.choice(n, size=cnt, replace=False)
            sel = np.zeros(n, np.float32)
            sel[idx] = 1.0
        self._cached = (sel, sel)
        return self._cached


class GOSSStrategy(SampleStrategy):
    """Gradient-based one-side sampling (ref: goss.hpp:19): keep the top
    ``top_rate`` rows by sum_k |g_k * h_k|, randomly keep ``other_rate`` of
    the rest with g/h amplified by (n - top_k)/other_k. Starts after
    1/learning_rate iterations (ref: goss.hpp:33). ``sample`` draws on
    the host; ``sample_dev`` on the device, under asynchronous
    boosting."""

    needs_grad = True

    def __init__(self, config: Config, num_data: int,
                 num_tree_per_iteration: int = 1):
        super().__init__(config, num_data, num_tree_per_iteration)
        if not (config.top_rate > 0 and config.other_rate > 0):
            log.fatal("GOSS requires top_rate > 0 and other_rate > 0")
        if config.top_rate + config.other_rate > 1.0:
            log.fatal("top_rate + other_rate must be <= 1.0 for GOSS")
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            log.fatal("Cannot use bagging in GOSS")
        log.info("Using GOSS")
        self.rng = np.random.default_rng(config.bagging_seed)

    def is_hessian_change(self):
        return True

    def _policy(self, it):
        """(top_k, other_k, multiply), or None during the 1/learning_rate
        warm-up (ref: goss.hpp:19-45): the one policy of both draws."""
        cfg = self.config
        if it < int(1.0 / cfg.learning_rate):
            return None
        n = self.num_data
        top_k = max(1, int(n * cfg.top_rate))
        other_k = max(1, int(n * cfg.other_rate))
        return top_k, other_k, (n - top_k) / other_k

    def sample_dev(self, it: int, grad: torch.Tensor, hess: torch.Tensor,
                   key) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """GOSS on the gradients' device, the JAX package's ``sample_dev``
        bit for bit (ref: models/sample_strategy.py:185-223): ``sum_k
        |g h|`` in f32, the classes added in order; the threshold is the
        top_k-th largest value (``lax.top_k(g, top_k)[0][-1]``); the
        rest are kept where the threefry uniforms of ``key`` fall under
        the f32 ``min(1, other_k / n_rest)``, and weighted by the f32
        ``multiply``. A stateless draw, not the host generator's: a
        GOSS model under asynchronous boosting differs from the
        synchronous one, as in the JAX package. Nothing is read to the
        host. Returns f32 ``(selected, weight)`` ``[N]``, or None in the
        warm-up."""
        pol = self._policy(it)
        if pol is None:
            return None
        top_k, other_k, multiply = pol
        dev = grad.device
        prod = torch.abs(grad * hess)                    # [K, N]
        g = prod[0]
        for k in range(1, prod.shape[0]):
            g = g + prod[k]
        threshold = torch.topk(g, top_k).values[-1]
        is_top = g >= threshold
        rest = ~is_top
        n_rest = rest.sum().clamp_min(1).to(torch.float32)
        keep_prob = torch.clamp(
            torch.tensor(other_k, dtype=torch.float32, device=dev) / n_rest,
            max=1.0)
        sampled = rest & (prng.uniform(key, g.shape[0], dev) < keep_prob)
        sel = (is_top | sampled).to(torch.float32)
        weight = torch.where(
            sampled, torch.tensor(multiply, dtype=torch.float32, device=dev),
            torch.tensor(1.0, dtype=torch.float32, device=dev)) * sel
        return sel, weight

    def sample(self, it, grad=None, hess=None):
        pol = self._policy(it)
        if pol is None:
            return None
        top_k, other_k, multiply = pol
        n = self.num_data
        # grad/hess may be [K, N]; rank by sum over classes of |g*h|
        g = np.abs(np.asarray(grad, np.float64) * np.asarray(hess, np.float64))
        if g.ndim == 2:
            g = g.sum(axis=0)
        threshold = np.partition(g, n - top_k)[n - top_k]
        is_top = g >= threshold
        rest = ~is_top
        n_rest = int(rest.sum())
        keep_prob = min(1.0, other_k / max(n_rest, 1))
        sampled = rest & (self.rng.random(n) < keep_prob)
        sel = (is_top | sampled).astype(np.float32)
        weight = np.where(sampled, multiply, 1.0).astype(np.float32) * sel
        return sel, weight
