"""DreamerV3: model-based RL — an RSSM world model learned from replayed
experience, with actor and critic trained entirely in imagination. The
port of ``ray_tpu/rllib/dreamerv3.py``.

Copied (numpy, and with an ``xp`` that is numpy or torch for the math):
``symlog``/``symexp``, the twohot code over 255 symlog bins,
``init_dreamer_params`` (numpy ``default_rng``: the reference's weights),
:class:`SequenceReplay`, the acting :class:`DreamerV3Module` and the
config and algorithm, with the continuous-action gate and the
arrival-stream conversion.

:class:`DreamerV3Learner` turns the reference's one jitted program
(posterior scan, heads, KL balancing with free bits, imagination scan,
lambda-returns, twohot critic with a slow-critic regulariser, REINFORCE
actor with percentile scaling, clipped Adam, the slow critic's EMA) into
one eager torch function on the learner's device: each ``lax.scan`` is a
Python loop over time, and every stop-gradient sits where the
reference's does. Its random draws follow the reference's key chain with
the port's threefry (bit-equal to ``jax.random``): each update splits the
learner key into (next key, k), k into k1, k2; ``split(k1, L)`` gives
the posterior samples' keys, ``split(k2, H)`` the imagination steps',
each split again into (action key, latent key). A categorical draw is
``argmax(gumbel + logits)`` with one key over the whole block, as
``jax.random.categorical``; the Gumbel noise of all L (or H) steps is
drawn before the loops, in one call over the step keys as lanes.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .._private import prng, tree
from .._private.device import DeviceLike, full_f32, resolve_device
from ._optim import Adam, value_and_grad
from .algorithm import Algorithm, AlgorithmConfig
from .learner import LearnerGroup
from .rl_module import RLModuleSpec, params_to_numpy, params_to_torch
from .sac import squash_logp

# ------------------------------------------------------------------ math


def symlog(x, xp=np):
    return xp.sign(x) * xp.log1p(xp.abs(x))


def symexp(x, xp=np):
    return xp.sign(x) * (xp.exp(xp.abs(x)) - 1.0)


NUM_BINS = 255  # twohot support: uniform bins over [-20, 20] in
# SYMLOG space (callers encode twohot(symlog(y)) and decode
# symexp(bins @ p) — reference: DreamerV3 paper eq. 9/10; 255 bins
# (the paper's count) give ~0.16 symlog resolution — coarse bins
# can't discriminate sub-unit reward differences).


def _jnp_linspace_bins() -> np.ndarray:
    """``jnp.linspace(-20.0, 20.0, 255)``'s float32 values, bit for bit.

    They are neither ``np.linspace`` nor ``torch.linspace`` in float32:
    XLA folds ``start * (1 - i / 254) + stop * i / 254`` into ``c =
    f32(1 / 254)``, ``c20 = f32(20 * c)`` and ``fma(i, c20, f32(-20 *
    f32(1 - f32(i * c))))`` (its CPU backend contracts the last multiply
    into the add), then appends ``stop``. The float64 sum of the exact
    product and the float32 term, rounded to float32, is that FMA here
    (``tests/test_torch_rllib_dreamer.py`` holds every bin equal)."""
    f32 = np.float32
    i = np.arange(NUM_BINS - 1, dtype=f32)
    c = f32(f32(1.0) / f32(NUM_BINS - 1))
    c20 = f32(f32(20.0) * c)
    head = f32(-20.0) * (f32(1.0) - i * c)
    fused = (i.astype(np.float64) * np.float64(c20)
             + head.astype(np.float64)).astype(f32)
    return np.concatenate([fused, np.array([20.0], f32)])


_BINS_F32 = _jnp_linspace_bins()
_BINS_ON: Dict[torch.device, torch.Tensor] = {}


def _bins(xp=np, device=None):
    """The twohot bins: float64 ``np.linspace`` for numpy (the acting
    module's), JAX's float32 values for torch (the learner's)."""
    if xp is np:
        return np.linspace(-20.0, 20.0, NUM_BINS)
    device = torch.device(device if device is not None else "cpu")
    if device not in _BINS_ON:
        _BINS_ON[device] = torch.from_numpy(_BINS_F32).to(device)
    return _BINS_ON[device]


def twohot(y, xp=np):
    """Encode scalars as a two-hot distribution over the symlog bins
    (reference: DreamerV3 paper eq. 9 / ``utils/symlog.py``)."""
    if xp is not np:
        return _twohot_torch(y)
    bins = _bins(xp)
    y = xp.clip(y, bins[0], bins[-1])
    idx = xp.sum((bins[None, :] <= y[:, None]).astype(xp.int32),
                 axis=-1) - 1
    idx = xp.clip(idx, 0, NUM_BINS - 2)
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (y - lo) / (hi - lo)
    out = xp.zeros((y.shape[0], NUM_BINS), xp.float32)
    rows = xp.arange(y.shape[0])
    out[rows, idx] = 1.0 - w_hi
    out[rows, idx + 1] = w_hi
    return out


def _twohot_torch(y: torch.Tensor) -> torch.Tensor:
    bins = _bins(torch, y.device)
    # Every caller's y is a constant (a target), so the clip's gradient
    # at a bound (jnp.clip's 0.5, torch.clamp's 1) never enters.
    y = torch.clamp(y, bins[0], bins[-1])
    idx = (bins[None, :] <= y[:, None]).to(torch.int32).sum(-1) - 1
    idx = torch.clamp(idx, 0, NUM_BINS - 2).long()
    lo, hi = bins[idx], bins[idx + 1]
    w_hi = (y - lo) / (hi - lo)
    out = torch.zeros((y.shape[0], NUM_BINS), dtype=torch.float32,
                      device=y.device)
    rows = torch.arange(y.shape[0], device=y.device)
    out[rows, idx] = 1.0 - w_hi
    out[rows, idx + 1] = w_hi
    return out


def twohot_mean(logits, xp=np):
    """Expected value of a twohot-categorical head."""
    p = _softmax(logits, xp)
    if xp is np:
        return p @ _bins(xp)
    return p @ _bins(xp, logits.device)


def _softmax(x, xp=np):
    if xp is np:
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


# ------------------------------------------------------------------ init


def _dense(rng, fan_in, fan_out, scale=1.0):
    w = rng.normal(0, scale / np.sqrt(fan_in),
                   (fan_in, fan_out)).astype(np.float32)
    return {"w": w, "b": np.zeros(fan_out, np.float32)}


def _mlp(rng, sizes, scale=1.0):
    return [_dense(rng, sizes[i], sizes[i + 1], scale)
            for i in range(len(sizes) - 1)]


def init_dreamer_params(spec: RLModuleSpec, cfg, seed: int) -> Dict:
    rng = np.random.default_rng(seed)
    D, S, C, U = cfg.deter_dim, cfg.stoch_dims, cfg.stoch_classes, cfg.units
    z_dim = S * C
    feat = D + z_dim
    obs = spec.obs_dim
    act = spec.num_actions
    return {
        "encoder": _mlp(rng, (obs, U, U)),
        # GRU over [z, a] with deter state D: one fused kernel for the
        # reset/update/candidate gates.
        "gru": _dense(rng, z_dim + act + D, 3 * D),
        "prior": _mlp(rng, (D, U)) + [_dense(rng, U, z_dim, 0.1)],
        "posterior": _mlp(rng, (D + U, U)) + [_dense(rng, U, z_dim, 0.1)],
        "decoder": _mlp(rng, (feat, U, U)) + [_dense(rng, U, obs)],
        "reward": _mlp(rng, (feat, U)) + [_dense(rng, U, NUM_BINS, 0.0)],
        "cont": _mlp(rng, (feat, U)) + [_dense(rng, U, 1)],
        "actor": _mlp(rng, (feat, U)) + [_dense(
            rng, U, 2 * act if spec.continuous else act, 0.01)],
        "critic": _mlp(rng, (feat, U)) + [_dense(rng, U, NUM_BINS, 0.0)],
    }


# ------------------------------------------------------------ seq replay


class SequenceReplay:
    """Fragment store over ARRIVAL-aligned rows (the reference keeps a
    uniform replay of episode sequences, ``EpisodeReplayBuffer``; here
    the per-slot stream IS the paper's convention already):

    - row t carries ``obs`` = the observation ARRIVED AT, ``a_prev`` =
      the action that produced it, ``rewards`` = the reward received on
      arrival, ``terms`` = whether this arrival ends the episode.
    - episode starts are explicit rows (``is_first``; a_prev/reward
      zero) and TERMINAL ARRIVAL observations are real rows, so reward
      and continue heads train on the paper's targets — including
      p(continue)=0 exactly at terminal arrivals.

    Windows force ``is_first`` at their first row (the posterior scan
    burns in from the zero state mid-episode, reference-style)."""

    KEYS = ("obs", "a_prev", "rewards", "terms", "is_first")

    def __init__(self, capacity_fragments: int, seq_len: int, seed: int = 0):
        self.capacity = capacity_fragments
        self.seq_len = seq_len
        self._frags: List[Dict[str, np.ndarray]] = []
        self._rng = np.random.default_rng(seed)

    def add_fragment(self, frag: Dict[str, np.ndarray]):
        if len(frag["obs"]) >= self.seq_len:
            self._frags.append(frag)
            if len(self._frags) > self.capacity:
                self._frags.pop(0)

    def __len__(self):
        return len(self._frags)

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        out = {k: [] for k in self.KEYS}
        for _ in range(batch):
            f = self._frags[self._rng.integers(len(self._frags))]
            t0 = self._rng.integers(0, len(f["obs"]) - self.seq_len + 1)
            sl = slice(t0, t0 + self.seq_len)
            is_first = f["is_first"][sl].copy().astype(bool)
            is_first[0] = True  # window start burns in from zero state
            out["obs"].append(f["obs"][sl])
            out["a_prev"].append(f["a_prev"][sl])
            out["rewards"].append(f["rewards"][sl])
            out["terms"].append(f["terms"][sl])
            out["is_first"].append(is_first)
        return {k: np.stack(v).astype(np.float32) if k != "a_prev"
                else np.stack(v) for k, v in out.items()}


# ------------------------------------------------------------- learner


def _net(layers, x, act_last=False):
    """An MLP forward: silu after every layer but the last (and after
    the last too with ``act_last``)."""
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if act_last or i < len(layers) - 1:
            x = F.silu(x)
    return x


def _gru(p, h, x):
    g = torch.cat([x, h], -1) @ p["w"] + p["b"]
    r, u, c = torch.chunk(g, 3, -1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    cand = torch.tanh(r * c)
    return u * cand + (1 - u) * h


def _sg_tree(t):
    return tree.map_with_path(lambda _, x: x.detach(), t)


class DreamerV3Learner:
    """World-model + actor-critic update as one eager step on the
    learner's device (the card unless ``device`` says otherwise)."""

    def __init__(self, spec: RLModuleSpec, cfg, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = spec
        self.cfg = cfg
        params = init_dreamer_params(spec, cfg, seed)
        self.params = params_to_torch(params, self.device)
        self._key = torch.from_numpy(
            prng.PRNGKey(seed).astype(np.int64)).to(self.device)
        self._opt = Adam(cfg.lr, grad_clip=cfg.grad_clip)
        self._opt_state = self._opt.init(self.params)
        self._slow_critic = params_to_torch(params["critic"], self.device)
        self.continuous = bool(spec.continuous)
        if self.continuous:
            self._a_low = torch.from_numpy(np.asarray(
                spec.action_low, np.float32)).to(self.device)
            self._a_high = torch.from_numpy(np.asarray(
                spec.action_high, np.float32)).to(self.device)
        #: The last update's samples (int64, on the device): posterior
        #: latents ``[L, B, S]``, imagined latents ``[H, B*L, S]`` and,
        #: for discrete actions, imagined actions ``[H, B*L]``.
        self.last_draws: Dict[str, torch.Tensor] = {}

    # ---------------------------------------------------------- draws
    def draws(self, key: torch.Tensor, B: int, L: int
              ) -> Dict[str, torch.Tensor]:
        """Every key and noise block of one update from its key k:
        ``k1, k2 = split(k)``; ``obs_keys = split(k1, L)`` and their
        Gumbel noise ``[L, B, S, C]``; ``img_keys = split(k2, H)``, each
        split into ``ka``/``kz``: the actions' noise ``[H, N, A]``
        (Gumbel, or standard normals for continuous actions) and the
        imagined latents' Gumbel noise ``[H, N, S, C]``, N = B * L."""
        cfg = self.cfg
        S, C, H = cfg.stoch_dims, cfg.stoch_classes, cfg.horizon
        N = B * L
        k1, k2 = prng.split(key)
        obs_keys = prng.split(k1, L)
        img_keys = prng.split(k2, H)
        sub = prng.split(img_keys)            # [H, 2, 2]
        ka, kz = sub[:, 0], sub[:, 1]
        act = self.spec.num_actions
        return {
            "k1": k1, "k2": k2, "obs_keys": obs_keys, "img_keys": img_keys,
            "ka": ka, "kz": kz,
            "obs": prng.gumbel(obs_keys, (B, S, C)),
            "act": (prng.normal(ka, (N, act)) if self.continuous
                    else prng.gumbel(ka, (N, act))),
            "z": prng.gumbel(kz, (N, S, C))}

    # ---------------------------------------------------------- model
    def _unimix_logits(self, logits):
        # 1% uniform mixing keeps KL finite (paper sec. 3).
        S, C = self.cfg.stoch_dims, self.cfg.stoch_classes
        probs = torch.softmax(logits.reshape(logits.shape[:-1] + (S, C)),
                              -1)
        probs = 0.99 * probs + 0.01 / C
        return torch.log(probs)

    def _sample_z(self, noise, logits):
        """``(z, idx)``: the categorical sample ``argmax(noise + lg)`` of
        the unimix logits, one-hot with straight-through gradients."""
        lg = self._unimix_logits(logits)
        idx = torch.argmax(noise + lg.detach(), -1)
        one = F.one_hot(idx, self.cfg.stoch_classes).to(lg.dtype)
        probs = torch.exp(lg)
        return one + probs - probs.detach(), idx

    def _kl(self, lhs_logits, rhs_logits):
        """KL(lhs || rhs) summed over latent dims, free-bits 1."""
        S, C = self.cfg.stoch_dims, self.cfg.stoch_classes
        lp = F.log_softmax(
            lhs_logits.reshape(lhs_logits.shape[:-1] + (S, C)), -1)
        rp = F.log_softmax(
            rhs_logits.reshape(rhs_logits.shape[:-1] + (S, C)), -1)
        k = (torch.exp(lp) * (lp - rp)).sum(-1).sum(-1)
        # torch.maximum, as jnp.maximum: a tie's gradient is split.
        return torch.maximum(k, torch.ones_like(k))  # free bits

    def _feat(self, h, z):
        S, C = self.cfg.stoch_dims, self.cfg.stoch_classes
        return torch.cat([h, z.reshape(z.shape[:-2] + (S * C,))], -1)

    def _observe(self, p, noise, batch, rec):
        """Posterior scan over a [B, L] ARRIVAL-aligned batch: row t's
        ``a_prev`` is the action that produced ``obs_t``, so the
        recurrence absorbs (a_prev_t, obs_t) directly."""
        cfg = self.cfg
        D, S, C = cfg.deter_dim, cfg.stoch_dims, cfg.stoch_classes
        act_n = self.spec.num_actions
        obs = batch["obs"]
        B, L = obs.shape[:2]
        emb = _net(p["encoder"], symlog(obs, torch), act_last=True)
        if self.continuous:
            a_feed = batch["a_prev"].reshape(B, L, act_n)
        else:
            a_feed = F.one_hot(batch["a_prev"].long(), act_n).to(obs.dtype)
        h = obs.new_zeros((B, D))
        z = obs.new_zeros((B, S, C))
        hs, zs, priors, posts, idxs = [], [], [], [], []
        for t in range(L):
            reset = batch["is_first"][:, t][:, None]
            h = h * (1 - reset)
            z = z * (1 - reset[..., None])
            a_prev = a_feed[:, t] * (1 - reset)  # no action "into"
            # an episode start (its a_prev row is a placeholder)
            h = _gru(p["gru"], h, torch.cat([z.reshape(B, S * C), a_prev],
                                            -1))
            prior_lg = _net(p["prior"], h)
            post_lg = _net(p["posterior"], torch.cat([h, emb[:, t]], -1))
            z, idx = self._sample_z(noise[t], post_lg)
            z = z.reshape(B, S, C)
            hs.append(h)
            zs.append(z)
            priors.append(prior_lg)
            posts.append(post_lg)
            idxs.append(idx)
        rec["observe"] = torch.stack(idxs)
        # stacked time-major; moved to [B, L, ...]
        return tuple(torch.stack(x, 1) for x in (hs, zs, priors, posts))

    def _wm_loss(self, p, noise, batch, rec):
        hs, zs, priors, posts = self._observe(p, noise, batch, rec)
        feat = self._feat(hs, zs)
        B, L = batch["obs"].shape[:2]
        recon = _net(p["decoder"], feat)
        l_obs = ((recon - symlog(batch["obs"], torch)) ** 2).sum(-1)
        # ARRIVAL convention: feat_t has absorbed (a_{t-1}, obs_t); its
        # reward target is the reward RECEIVED on arrival and its
        # continue target is 0 exactly at terminal arrivals.
        rew_lg = _net(p["reward"], feat).reshape(B * L, NUM_BINS)
        rew_t = twohot(symlog(batch["rewards"], torch).reshape(-1), torch)
        l_rew = -(rew_t * F.log_softmax(rew_lg, -1)).sum(-1)
        cont_lg = _net(p["cont"], feat)[..., 0]
        cont_target = 1.0 - batch["terms"]
        l_cont = torch.maximum(cont_lg, torch.zeros_like(cont_lg)) \
            - cont_lg * cont_target \
            + torch.log1p(torch.exp(-torch.abs(cont_lg)))
        l_dyn = self._kl(posts.detach(), priors)
        l_rep = self._kl(posts, priors.detach())
        loss = (l_obs.mean() + l_rew.mean() + l_cont.mean()
                + 0.5 * l_dyn.mean() + 0.1 * l_rep.mean())
        metrics = {"wm/obs": l_obs.mean(), "wm/reward": l_rew.mean(),
                   "wm/cont": l_cont.mean(), "wm/kl": l_dyn.mean()}
        return loss, hs, zs, metrics

    def _imagine(self, p, noise, h, z, rec):
        """Actor rollout in latent space for ``horizon`` steps.

        Emits the PRE-advance state each step — (s_t, a_t aux) with s_0
        the start state — and returns the final carry s_H for the value
        bootstrap."""
        S, C = self.cfg.stoch_dims, self.cfg.stoch_classes
        act_n = self.spec.num_actions
        N = h.shape[0]
        outs: List[tuple] = []
        zidx, aidx = [], []
        for t in range(self.cfg.horizon):
            feat = self._feat(h, z)
            out = _net(p["actor"], feat)
            if self.continuous:
                mean, raw_std = torch.chunk(out, 2, -1)
                # paper's std parameterization: bounded, smooth, never
                # below min_std
                std = 2.0 * torch.sigmoid(raw_std / 2.0) + 0.1
                log_std = torch.log(std)
                u = mean + std * noise["act"][t]
                a_feed = self._a_low + (torch.tanh(u) + 1.0) * 0.5 * (
                    self._a_high - self._a_low)
                aux = (u, mean, log_std)
            else:
                a = torch.argmax(noise["act"][t] + out.detach(), -1)
                a_feed = F.one_hot(a, act_n).to(out.dtype)
                aux = (out, a)
                aidx.append(a)
            h_next = _gru(p["gru"], h, torch.cat([z.reshape(N, S * C),
                                                  a_feed], -1))
            z_next, idx = self._sample_z(noise["z"][t],
                                         _net(p["prior"], h_next))
            zidx.append(idx)
            outs.append((h, z) + aux)
            h, z = h_next, z_next.reshape(N, S, C)
        rec["imagine_z"] = torch.stack(zidx)
        if aidx:
            rec["actions"] = torch.stack(aidx)
        # time-major [H, N, ...]: (s_t h, s_t z, *aux at s_t)
        return [torch.stack(x) for x in zip(*outs)], (h, z)

    def _lambda_returns(self, rew, cont, values, lam=0.95):
        """Bootstrapped lambda-returns, time-major [H, N]; ``values``
        carries H+1 entries (bootstrap at the end)."""
        nxt = values[-1]
        rets = [None] * rew.shape[0]
        for t in range(rew.shape[0] - 1, -1, -1):
            nxt = rew[t] + self.cfg.gamma * cont[t] * (
                (1 - lam) * values[t + 1] + lam * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def _ac_loss(self, p, slow_critic, noise, hs, zs, r_caps, rec):
        cfg = self.cfg
        D, S, C = cfg.deter_dim, cfg.stoch_dims, cfg.stoch_classes
        # Imagination starts from every posterior state (flattened);
        # gradients do not flow back into the world model.
        h0 = hs.reshape(-1, D).detach()
        z0 = zs.reshape(-1, S, C).detach()
        (ih, iz, *aux), (h_last, z_last) = self._imagine(
            {**p, "gru": _sg_tree(p["gru"]), "prior": _sg_tree(p["prior"]),
             "reward": _sg_tree(p["reward"]), "cont": _sg_tree(p["cont"])},
            noise, h0, z0, rec)
        feat = self._feat(ih, iz)  # [H, N, F] — s_0..s_{H-1}
        H, N = feat.shape[:2]
        r_lo, r_hi, v_cap = r_caps
        feat_last = self._feat(h_last, z_last)[None]  # s_H
        # The return estimate reaches the loss only through
        # stop-gradients (sg(rets), sg(rets - values), sg(disc)), so it
        # is built without a graph: the same values, and its clips'
        # gradients never matter.
        with torch.no_grad():
            # ARRIVAL convention: the reward/continue for action a_t
            # live at the SUCCESSOR state s_{t+1}; the heads are
            # parameter-stopped.
            feat_next = torch.cat([feat[1:], feat_last], 0)
            rew = twohot_mean(_net(p["reward"], feat_next).reshape(
                H * N, -1), torch).reshape(H, N)
            # ground imagination in the replayed reward range (symlog)
            rew = symexp(torch.clamp(rew, r_lo, r_hi), torch)
            cont = torch.sigmoid(_net(p["cont"], feat_next)[..., 0])
            v_lg = _net(p["critic"], feat).reshape(H * N, -1)
            values = symexp(torch.clamp(twohot_mean(v_lg, torch), -v_cap,
                                        v_cap), torch).reshape(H, N)
            # bootstrap with V(s_H) from the final carry
            v_last = symexp(torch.clamp(twohot_mean(
                _net(p["critic"], feat_last[0]), torch), -v_cap, v_cap),
                torch)
            vals_ext = torch.cat([values, v_last[None]], 0)
            rets = self._lambda_returns(rew, cont, vals_ext)  # [H, N]
            # discount weights: product of continues up to t
            disc = torch.cumprod(torch.cat([cont.new_ones((1, N)),
                                            cont[:-1]], 0), 0)

        # Critic: twohot CE on symlog lambda-returns + EMA
        # regularization toward the slow critic, on STOPPED feats.
        tgt = twohot(symlog(rets, torch).reshape(-1), torch)
        feat_sg = feat.detach()
        logp_v = F.log_softmax(
            _net(p["critic"], feat_sg).reshape(H * N, -1), -1)
        l_critic = -(tgt * logp_v).sum(-1).reshape(H, N)
        slow_lg = _net(slow_critic, feat_sg).reshape(H * N, -1)
        l_slow = -(torch.softmax(slow_lg, -1)
                   * logp_v).sum(-1).reshape(H, N)
        critic_loss = ((l_critic + l_slow) * disc).mean()

        # Actor: REINFORCE with percentile-normalized advantages.
        adv = rets - values
        lo = torch.quantile(rets, 0.05)
        hi = torch.quantile(rets, 0.95)
        scale = torch.clamp_min(hi - lo, 1.0)
        if self.continuous:
            u, mean, log_std = aux
            # score function on the taken action (sample stopped);
            # the entropy bonus differentiates through the sample
            lp = squash_logp(u.detach(), log_std, mean, torch)
            ent = -squash_logp(u, log_std, mean, torch)
        else:
            a_lgs, acts = aux
            logp_a = F.log_softmax(a_lgs, -1)
            lp = logp_a.gather(-1, acts[..., None])[..., 0]
            ent = -(torch.exp(logp_a) * logp_a).sum(-1)
        actor_loss = -(disc * (lp * adv / scale
                               + cfg.entropy_coeff * ent)).mean()
        metrics = {"ac/critic": critic_loss, "ac/actor": actor_loss,
                   "ac/entropy": ent.mean(),
                   "ac/return": rets.mean(), "ac/value": values[0].mean()}
        return actor_loss + critic_loss, metrics

    def _loss_fn(self, p, slow_critic, noise, batch, rec):
        gamma = self.cfg.gamma
        wm, hs, zs, m1 = self._wm_loss(p, noise["obs"], batch, rec)
        with torch.no_grad():
            r_sym = symlog(batch["rewards"], torch)
            r_lo, r_hi = r_sym.min() - 0.5, r_sym.max() + 0.5
            bound = torch.maximum(torch.abs(symexp(r_lo, torch)),
                                  torch.abs(symexp(r_hi, torch)))
            v_cap = symlog(bound / (1.0 - gamma) + 1.0, torch)
        ac, m2 = self._ac_loss(p, slow_critic, noise, hs, zs,
                               (r_lo, r_hi, v_cap), rec)
        return wm + ac, {**m1, **m2}

    def _feed(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return params_to_torch({k: np.asarray(v) for k, v in batch.items()},
                               self.device)

    # ------------------------------------------------------------- api
    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        self._key, k = prng.split(self._key)
        feed = self._feed(batch)
        B, L = feed["obs"].shape[:2]
        noise = self.draws(k, B, L)
        rec: Dict[str, torch.Tensor] = {}
        with full_f32():
            (loss, metrics), grads = value_and_grad(
                self._loss_fn, self.params, self._slow_critic, noise, feed,
                rec)
            self.params, self._opt_state = self._opt.update(
                self.params, grads, self._opt_state)
            # slow critic EMA (paper's tau)
            with torch.no_grad():
                self._slow_critic = tree.map_with_path(
                    lambda _, s, c: 0.98 * s + 0.02 * c,
                    self._slow_critic, self.params["critic"])
        self.last_draws = rec
        metrics["loss"] = loss
        return {k2: float(v) for k2, v in metrics.items()}

    def wm_only(self, params, key, batch):
        """The world-model loss and its metrics for ``params`` (a tree
        of tensors on the learner's device) under ``key``."""
        key = torch.as_tensor(np.asarray(key).astype(np.int64),
                              device=self.device)
        feed = self._feed(batch)
        noise = prng.gumbel(prng.split(key, feed["obs"].shape[1]), (
            feed["obs"].shape[0], self.cfg.stoch_dims,
            self.cfg.stoch_classes))
        with full_f32(), torch.no_grad():
            loss, _, _, metrics = self._wm_loss(params, noise, feed, {})
        return loss, metrics

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, params):
        self.params = params_to_torch(params, self.device)

    def get_state(self):
        return {"params": self.get_weights(),
                "opt": params_to_numpy(self._opt_state),
                "slow": params_to_numpy(self._slow_critic)}

    def set_state(self, state):
        self.params = params_to_torch(state["params"], self.device)
        self._opt_state = params_to_torch(state["opt"], self.device)
        self._slow_critic = params_to_torch(state["slow"], self.device)


# ------------------------------------------------------------- module


class DreamerV3Module:
    """Acting-side RSSM: numpy forward with per-slot recurrent state
    (the card belongs to the learner; rollouts are host inference).

    ``recurrent = True`` tells the env runner to pass explicit ``slots``
    on sub-batch value queries so rows map to the right state."""

    recurrent = True

    def __init__(self, spec: RLModuleSpec, seed: int = 0, cfg=None):
        self.spec = spec
        self.cfg = cfg or DreamerV3Config()
        self.params = init_dreamer_params(spec, self.cfg, seed)
        self._state: Dict[int, Any] = {}  # slot -> (h, z_flat, a_prev)

    # numpy math mirrors the learner's model (silu MLPs, fused GRU)
    @staticmethod
    def _mlp(layers, x, act_last=False):
        for i, l in enumerate(layers):
            x = x @ l["w"] + l["b"]
            if act_last or i < len(layers) - 1:
                x = x * (1.0 / (1.0 + np.exp(-x)))  # silu
        return x

    def _gru(self, h, x):
        p = self.params["gru"]
        g = np.concatenate([x, h], -1) @ p["w"] + p["b"]
        D = self.cfg.deter_dim
        r = 1 / (1 + np.exp(-g[:, :D]))
        u = 1 / (1 + np.exp(-g[:, D:2 * D]))
        cand = np.tanh(r * g[:, 2 * D:])
        return u * cand + (1 - u) * h

    def on_episode_reset(self, slot: int):
        self._state.pop(slot, None)

    def _step_state(self, obs, slots=None):
        cfg, S, C = self.cfg, self.cfg.stoch_dims, self.cfg.stoch_classes
        n = obs.shape[0]
        act_n = self.spec.num_actions
        h = np.zeros((n, cfg.deter_dim), np.float32)
        z = np.zeros((n, S * C), np.float32)
        a = np.zeros((n, act_n), np.float32)
        for i in range(n):
            st = self._state.get(i if slots is None else int(slots[i]))
            if st is not None:
                h[i], z[i], a[i] = st
        emb = self._mlp(self.params["encoder"], symlog(obs), act_last=True)
        h = self._gru(h, np.concatenate([z, a], -1))
        post = self._mlp(self.params["posterior"],
                         np.concatenate([h, emb], -1))
        probs = _softmax(post.reshape(n, S, C))
        probs = 0.99 * probs + 0.01 / C
        # mode latents for acting (sampling buys nothing on-policy here)
        z = np.eye(C, dtype=np.float32)[probs.argmax(-1)].reshape(n, S * C)
        feat = np.concatenate([h, z], -1)
        return h, z, feat

    def _to_env(self, tanh_a):
        lo, hi = self.spec.action_low, self.spec.action_high
        return lo + (tanh_a + 1.0) * 0.5 * (hi - lo)

    def forward_exploration(self, obs: np.ndarray, rng):
        h, z, feat = self._step_state(obs)
        out = self._mlp(self.params["actor"], feat)
        n = obs.shape[0]
        if self.spec.continuous:
            mean, raw_std = np.split(out, 2, -1)
            # mirror the learner's std parameterization
            std = 2.0 / (1.0 + np.exp(-raw_std / 2.0)) + 0.1
            log_std = np.log(std)
            u = mean + std * rng.standard_normal(mean.shape)
            env_a = self._to_env(np.tanh(u)).astype(np.float32)
            for i in range(n):
                self._state[i] = (h[i], z[i], env_a[i])
            logp = squash_logp(u, log_std, mean, np).astype(np.float32)
            values = symexp(twohot_mean(
                self._mlp(self.params["critic"], feat)))
            return env_a, logp, values
        p = _softmax(out)
        acts = np.array([rng.choice(len(row), p=row) for row in p])
        a_one = np.eye(self.spec.num_actions,
                       dtype=np.float32)[acts]
        for i in range(n):
            self._state[i] = (h[i], z[i], a_one[i])
        logp = np.log(p[np.arange(n), acts] + 1e-8)
        values = symexp(twohot_mean(
            self._mlp(self.params["critic"], feat)))
        return acts, logp, values

    def forward_inference(self, obs: np.ndarray):
        h, z, feat = self._step_state(obs)
        out = self._mlp(self.params["actor"], feat)
        if self.spec.continuous:
            mean, _ = np.split(out, 2, -1)
            env_a = self._to_env(np.tanh(mean)).astype(np.float32)
            for i in range(obs.shape[0]):
                self._state[i] = (h[i], z[i], env_a[i])
            return env_a
        acts = out.argmax(-1)
        a_one = np.eye(self.spec.num_actions, dtype=np.float32)[acts]
        for i in range(obs.shape[0]):
            self._state[i] = (h[i], z[i], a_one[i])
        return acts

    def forward_values(self, obs: np.ndarray, slots=None) -> np.ndarray:
        # Read-only: value queries must not advance the stored state.
        _, _, feat = self._step_state(obs, slots=slots)
        return symexp(twohot_mean(self._mlp(self.params["critic"], feat)))

    def get_weights(self):
        return self.params

    def set_weights(self, params):
        self.params = params


# ----------------------------------------------------------- algorithm


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.algo_class = DreamerV3
        # XS model size (reference size table)
        self.deter_dim = 256
        self.stoch_dims = 8
        self.stoch_classes = 8
        self.units = 256
        self.horizon = 15
        self.seq_len = 16
        self.batch_seqs = 8
        self.lr = 4e-5
        self.entropy_coeff = 3e-4
        # Continuous action spaces are gated out of the public surface
        # until they pass a learning probe (NOTES_r05): opt in
        # explicitly to experiment.
        self.experimental_continuous = False
        self.grad_clip = 1000.0
        self.replay_capacity_fragments = 500
        self.updates_per_iteration = 8
        self.rollout_fragment_length = 64
        self.num_steps_before_learning = 256


class DreamerV3(Algorithm):
    def __init__(self, config: DreamerV3Config):
        self._replay = None
        super().__init__(config)

    def _make_module_spec(self, config):
        spec = config.module_spec()
        if spec.continuous and not config.experimental_continuous:
            # GATED OUT of the public surface (round-5 probes,
            # NOTES_r05): with paper-faithful REINFORCE + the fixed
            # pathwise entropy bonus, XS-budget continuous control
            # still fails its improvement-over-random probe
            # (world-model exploitation + tanh-entropy decay).
            # Shipping a known-diverging mode silently would be worse
            # than refusing; the discrete path passes its learning
            # gates and stays public.
            raise ValueError(
                "DreamerV3 continuous-action support is EXPERIMENTAL "
                "and currently fails its learning probe at small model "
                "budgets (see NOTES_r05.md). Set "
                "config.experimental_continuous = True to use it "
                "anyway, or use SAC/PPO for continuous control.")
        cfg = config

        class _Bound(DreamerV3Module):
            def __init__(inner, spec_, seed=0):  # noqa: N805
                super().__init__(spec_, seed=seed, cfg=cfg)

        spec.module_cls = _Bound
        return spec

    def _build_learner_group(self):
        cfg = self.config
        if cfg.num_learners:
            raise ValueError(
                "DreamerV3 trains on a single (in-process) learner; "
                "num_learners>0 is not supported — the model-learn + "
                "imagination step is one program on the learner's "
                "device, not learner replicas")
        self._replay = SequenceReplay(cfg.replay_capacity_fragments,
                                      cfg.seq_len, seed=cfg.seed)
        self._learner = DreamerV3Learner(self.module_spec, cfg,
                                         seed=cfg.seed, device=cfg.device)
        self._updates = 0
        from collections import defaultdict

        # per-slot arrival-row accumulation (see training_step)
        self._slot_rows = defaultdict(
            lambda: {k: [] for k in SequenceReplay.KEYS})
        self._need_start = defaultdict(lambda: True)

        class _SoloGroup(LearnerGroup):
            def __init__(inner):  # noqa: N805 - tiny adapter
                inner.local = self._learner
                inner.num_learners = 0
                inner._pool = None

        return _SoloGroup()

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for batch in self.env_runner_group.sample():
            n = len(batch["obs"])
            self._timesteps += n
            T = cfg.rollout_fragment_length
            N = n // T

            def env_major(x):
                # runner batches are TIME-major [t0e0, t0e1, t1e0, ...];
                # replay wants one contiguous stream per env slot
                return x.reshape((T, N) + x.shape[1:]).swapaxes(0, 1)

            obs = env_major(batch["obs"])
            nxt = env_major(batch["next_obs"])
            acts = env_major(batch["actions"])
            rews = env_major(batch["rewards"])
            dones = env_major(batch["dones"])
            truncs = env_major(batch["truncateds"])
            # Convert to the ARRIVAL stream (see SequenceReplay): each
            # transition contributes the observation it ARRIVED AT
            # (``next_obs`` — the true successor, INCLUDING terminal
            # arrivals the obs column never contains), tagged with the
            # action/reward that produced it; episode starts are
            # explicit is_first rows. Streams persist across fragments
            # per slot (the runner's slots are continuous).
            zero_a = (np.zeros(self.module_spec.num_actions, np.float32)
                      if self.module_spec.continuous
                      else np.int64(0))
            for i in range(N):
                rows = self._slot_rows[i]
                for t in range(T):
                    if self._need_start[i]:
                        rows["obs"].append(obs[i, t])
                        rows["a_prev"].append(zero_a)
                        rows["rewards"].append(0.0)
                        rows["terms"].append(0.0)
                        rows["is_first"].append(1.0)
                        self._need_start[i] = False
                    rows["obs"].append(nxt[i, t])
                    rows["a_prev"].append(acts[i, t])
                    rows["rewards"].append(rews[i, t])
                    # only TERMINATIONS zero the continue target; a
                    # time-limit truncation is not an MDP exit
                    rows["terms"].append(float(dones[i, t]))
                    rows["is_first"].append(0.0)
                    if dones[i, t] or truncs[i, t]:
                        self._need_start[i] = True
                if len(rows["obs"]) >= max(cfg.seq_len, T):
                    self._replay.add_fragment({
                        k: np.stack(v) if k == "obs" or k == "a_prev"
                        else np.asarray(v, np.float32)
                        for k, v in rows.items()})
                    self._slot_rows[i] = {k: [] for k in
                                          SequenceReplay.KEYS}
        metrics: Dict[str, Any] = {}
        if self._timesteps >= cfg.num_steps_before_learning and \
                len(self._replay):
            for _ in range(cfg.updates_per_iteration):
                metrics = self._learner.update(
                    self._replay.sample(cfg.batch_seqs))
                self._updates += 1
        self.env_runner_group.sync_weights(self._learner.get_weights())
        metrics["replay_fragments"] = len(self._replay)
        metrics["num_updates"] = self._updates
        return metrics
