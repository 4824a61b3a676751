"""Learned flow refinement: train a CNN on top of the differentiable pipeline.

The modern production pattern is classic-coarse + learned-residual: a cheap
dense flow (here pyramidal LK) plus a small network that corrects its
systematic errors.  Because every op in this framework is pure JAX, the
learned component just slots in — flax convolutions over a
feature stack of [prev, warped next, coarse flow], optax adam, one jitted
train step.  The CUDA reference has no analogue of any of this.

Training data is synthesized with EXACT ground truth, no dataset needed:
draw a random texture ``nxt`` and a random smooth flow ``d``; under the
framework's convention prev(x) = nxt(x + d), so ``prev = warp(nxt, d)``
gives a pair whose true flow IS ``d``.

Run: python examples/learned_refinement.py  (CPU or GPU)
"""
import functools

import numpy as np

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

H, W = 64, 80
CFG = of.LKConfig(levels=2, window=9, iterations=1, use_pallas=False)


def make_pair(rng: np.random.Generator):
    """(prev, nxt, true_flow): random texture warped by a random smooth flow."""
    tex = rng.normal(0, 1, (H + 8, W + 8))
    k = np.ones(5) / 5.0  # cheap smoothing: trackable blobs, not white noise
    for ax in (0, 1):
        tex = np.apply_along_axis(np.convolve, ax, tex, k, mode="same")
    nxt = 127.0 + 300.0 * tex[4:-4, 4:-4]
    # smooth flow: global translation + low-frequency sinusoidal deformation
    tx, ty = rng.uniform(-2.5, 2.5, 2)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    u = tx + 0.7 * np.sin(2 * np.pi * ys / H) * np.cos(2 * np.pi * xs / W)
    v = ty + 0.7 * np.cos(2 * np.pi * ys / H) * np.sin(2 * np.pi * xs / W)
    flow = np.stack([u, v], -1).astype(np.float32)
    prev = np.asarray(
        warp_bilinear(jnp.asarray(nxt, jnp.float32), jnp.asarray(flow))
    )
    return prev.astype(np.float32), nxt.astype(np.float32), flow


class RefineNet(nn.Module):
    """3-conv residual head; zero-init output so training starts AT the
    classic flow (delta = 0) and can only improve from there."""

    feats: int = 16

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Conv(self.feats, (3, 3))(x))
        x = nn.relu(nn.Conv(self.feats, (3, 3))(x))
        return nn.Conv(2, (3, 3), kernel_init=nn.initializers.zeros)(x)


def features(prev, nxt, coarse):
    """(H, W, 4) input stack: the two (normalized) frames aligned by the
    coarse flow, plus the coarse flow itself."""
    aligned = warp_bilinear(nxt, coarse)
    return jnp.concatenate(
        [prev[..., None] / 255.0, aligned[..., None] / 255.0, coarse], -1
    )


def main():
    rng = np.random.default_rng(3)
    # Data is free (synthesized with exact truth), so generalization comes
    # from set size, not regularization tricks: 32 pairs is plenty for a
    # 3-conv head (8 overfits).
    train = [make_pair(rng) for _ in range(32)]
    test = [make_pair(rng) for _ in range(4)]

    coarse_jit = jax.jit(functools.partial(of.pyramidal_lk, config=CFG))

    def batch(pairs):
        prev = jnp.asarray(np.stack([p for p, _, _ in pairs]))
        nxt = jnp.asarray(np.stack([n for _, n, _ in pairs]))
        truth = jnp.asarray(np.stack([f for _, _, f in pairs]))
        coarse = jax.vmap(coarse_jit)(prev, nxt)
        feats = jax.vmap(features)(prev, nxt, coarse)
        return feats, coarse, truth

    tr_feats, tr_coarse, tr_truth = batch(train)
    te_feats, te_coarse, te_truth = batch(test)

    net = RefineNet()
    params = net.init(jax.random.key(0), tr_feats[0])
    opt = optax.adam(2e-3)
    opt_state = opt.init(params)

    def epe(flow, truth):
        d = flow - truth
        return jnp.sqrt(jnp.sum(d * d, -1) + 1e-12).mean()

    @jax.jit
    def train_step(params, opt_state):
        def loss_fn(p):
            delta = jax.vmap(lambda f: net.apply(p, f))(tr_feats)
            return epe(tr_coarse + delta, tr_truth)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    base_te = float(epe(te_coarse, te_truth))
    for step in range(250):
        params, opt_state, loss = train_step(params, opt_state)
        if step % 100 == 0:
            print(f"step {step:4d}  train EPE {float(loss):.4f}")

    delta = jax.vmap(lambda f: net.apply(params, f))(te_feats)
    refined_te = float(epe(te_coarse + delta, te_truth))
    print(f"held-out EPE: coarse {base_te:.4f} -> refined {refined_te:.4f} "
          f"({100 * (1 - refined_te / base_te):.0f}% better)")
    assert refined_te < 0.85 * base_te, (base_te, refined_te)


if __name__ == "__main__":
    main()
