"""Training loop for the pilot denoiser: optax + dp-sharded steps + .npz checkpoints.

The reference has no training loop or checkpointing at all (SURVEY.md §5
"Checkpoint/resume: not present — there is no trained state anywhere"); this module
supplies them: a jitted optax train step sharded over the mesh's `dp` axis
(gradients all-reduced by XLA from the sharding annotations — no hand-written
collectives), and save/restore of the whole train state as one numpy `.npz`
file for resume.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import denoiser


@dataclass
class TrainState:
    params: dict
    opt_state: optax.OptState
    step: int


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-5, decay_steps: int = 0):
    """adamw; with decay_steps > 0 the lr follows a cosine decay to 0 (measurably
    better final NMSE than constant lr in the architecture sweep). A constant lr
    is still wrapped as a schedule so the optimizer state structure is identical
    either way (checkpoints restore across both)."""
    sched = (
        optax.cosine_decay_schedule(lr, decay_steps)
        if decay_steps > 0
        else optax.constant_schedule(lr)
    )
    return optax.adamw(sched, weight_decay=weight_decay)


def init_state(
    seed: int = 0, n_re: int = 128, lr: float = 1e-3, decay_steps: int = 0
) -> Tuple[TrainState, optax.GradientTransformation]:
    params = denoiser.init_params(jax.random.key(seed), n_re)
    tx = make_optimizer(lr, decay_steps=decay_steps)
    return TrainState(params, tx.init(params), 0), tx


def build_train_step(tx, mesh: Optional[Mesh] = None, dp_axis: str = "dp"):
    """Jitted `(params, opt_state, noisy, truth) -> (params, opt_state, loss)`.

    With a mesh, the batch is sharded over `dp_axis` and parameters are replicated;
    XLA inserts the gradient all-reduce automatically (psum over dp).
    """

    def step(params, opt_state, noisy, truth):
        loss, grads = jax.value_and_grad(denoiser.nmse_loss)(params, noisy, truth)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    if mesh is None:
        return jax.jit(step)

    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P(dp_axis))
    return jax.jit(
        step,
        in_shardings=(repl, repl, data, data),
        out_shardings=(repl, repl, repl),
    )


def train(
    n_steps: int = 200,
    batch: int = 256,
    n_re=128,
    seed: int = 0,
    lr: float = 1e-3,
    mesh: Optional[Mesh] = None,
    log_every: int = 50,
    state: Optional[TrainState] = None,
) -> Tuple[TrainState, float]:
    """Train the denoiser on streamed synthetic batches; returns (state, last_loss).

    `n_re` may be a single pilot-lattice length or a TUPLE of lengths: the
    model is fully convolutional (geometry-independent parameters), so
    multi-geometry training just cycles batch shapes per step (one jitted
    executable per distinct length) and produces ONE checkpoint covering every
    serving geometry — narrowband 4-PRB (24 REs) through wideband 273-PRB
    (1638 REs). The per-step batch is scaled down for long lattices so the
    step cost stays roughly constant across the cycle.
    """
    rng = np.random.default_rng(seed)
    res = (n_re,) if isinstance(n_re, int) else tuple(n_re)
    if state is None:
        state, tx = init_state(seed, res[0], lr, decay_steps=n_steps)
    else:
        tx = make_optimizer(lr)  # resume: constant lr (cosine phase already spent)
    step_fn = build_train_step(tx, mesh)
    params, opt_state = state.params, state.opt_state
    loss = float("nan")
    for i in range(n_steps):
        nr_i = res[i % len(res)]
        # constant total RE count per step: batch * n_re ~ batch0 * min(res)
        b_i = max(8, (batch * min(res)) // nr_i)
        noisy, truth = denoiser.make_training_batch(rng, b_i, nr_i)
        params, opt_state, loss_j = step_fn(params, opt_state, noisy, truth)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            loss = float(loss_j)
            print(f"step {state.step + i:5d}  n_re {nr_i:4d}  nmse {loss:.4e}", flush=True)
    return TrainState(params, opt_state, state.step + n_steps), float(loss_j)


def init_state_2d(
    seed: int = 0, n_re: int = 128, n_dsym: int = 4, lr: float = 1e-3, decay_steps: int = 0
) -> Tuple[TrainState, optax.GradientTransformation]:
    params = denoiser.init_params_2d(jax.random.key(seed), n_dsym, n_re)
    tx = make_optimizer(lr, decay_steps=decay_steps)
    return TrainState(params, tx.init(params), 0), tx


def build_train_step_2d(tx, mesh: Optional[Mesh] = None, dp_axis: str = "dp"):
    def step(params, opt_state, noisy, truth):
        loss, grads = jax.value_and_grad(denoiser.nmse_loss_2d)(params, noisy, truth)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    if mesh is None:
        return jax.jit(step)
    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P(dp_axis))
    return jax.jit(
        step, in_shardings=(repl, repl, data, data), out_shardings=(repl, repl, repl)
    )


def train2d(
    n_steps: int = 200,
    batch: int = 128,
    n_re: int = 128,
    n_dsym: int = 4,
    seed: int = 0,
    lr: float = 1e-3,
    mesh: Optional[Mesh] = None,
    log_every: int = 50,
    state: Optional[TrainState] = None,
) -> Tuple[TrainState, float]:
    """Train the 2-D (time x frequency) denoiser on synthetic Doppler batches."""
    rng = np.random.default_rng(seed)
    if state is None:
        state, tx = init_state_2d(seed, n_re, n_dsym, lr, decay_steps=n_steps)
    else:
        tx = make_optimizer(lr)
    step_fn = build_train_step_2d(tx, mesh)
    params, opt_state = state.params, state.opt_state
    loss_j = jnp.nan
    for i in range(n_steps):
        noisy, truth = denoiser.make_training_batch_2d(rng, batch, n_re, n_dsym=n_dsym)
        params, opt_state, loss_j = step_fn(params, opt_state, noisy, truth)
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {state.step + i:5d}  nmse {float(loss_j):.4e}", flush=True)
    return TrainState(params, opt_state, state.step + n_steps), float(loss_j)


# ---------------------------------------------------------------------------
# Checkpointing (.npz: one array per pytree leaf, keyed by its tree path)
# ---------------------------------------------------------------------------


def _flatten(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {
        jax.tree_util.keystr(path, simple=True, separator="/"): np.asarray(leaf)
        for path, leaf in leaves
    }


def save_checkpoint(path, state: TrainState) -> None:
    """Write `state` to the file `path`, in numpy's `.npz` format."""
    arrays = _flatten({"params": state.params, "opt_state": state.opt_state})
    arrays["step"] = np.asarray(state.step, np.int64)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _restore(path, template: TrainState) -> TrainState:
    """Fill `template`'s tree with the arrays saved at `path`; every leaf must
    be present with the template's shape."""
    with np.load(path) as f:
        saved = dict(f)
    tree = {"params": template.params, "opt_state": template.opt_state}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for key_path, leaf in leaves:
        key = jax.tree_util.keystr(key_path, simple=True, separator="/")
        if key not in saved or saved[key].shape != np.shape(leaf):
            raise ValueError(f"checkpoint {path} does not match the model at {key}")
        out.append(jnp.asarray(saved[key], jnp.asarray(leaf).dtype))
    tree = jax.tree_util.tree_unflatten(treedef, out)
    return TrainState(tree["params"], tree["opt_state"], int(saved["step"]))


def load_checkpoint(path, seed: int = 0, n_re: int = 128, lr: float = 1e-3) -> TrainState:
    template, _ = init_state(seed, n_re, lr)
    return _restore(path, template)


def load_checkpoint_2d(
    path, seed: int = 0, n_re: int = 128, n_dsym: int = 4, lr: float = 1e-3
) -> TrainState:
    template, _ = init_state_2d(seed, n_re, n_dsym, lr)
    return _restore(path, template)
