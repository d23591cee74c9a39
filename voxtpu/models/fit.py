"""Vertex-position optimization against a target occupancy grid.

The flagship differentiable pipeline (BASELINE.json north star): soft
voxelization forward, a soft-IoU loss against a target occupancy, and
gradient descent on the mesh vertex coordinates. This is the capability
the CUDA reference cannot offer (its fill is parity bit-toggling,
`vox/sequential.cpp:56-57` — no gradients exist).

Usage::

    plan = make_soft_plan(mesh, spec)
    fit = VoxelFit(plan, target_occ)
    state = fit.init(mesh.coords)
    for _ in range(steps):
        state, metrics = fit.step(state)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from voxtpu.ops.soft_vox import soft_voxelize


@jax.jit
def _max_drift(coords, plan_coords, voxel_size):
    return jnp.max(jnp.abs(coords - plan_coords)) / voxel_size


def soft_iou_loss(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """1 - soft IoU; robust to class imbalance in mostly-empty grids."""
    inter = jnp.sum(pred * target)
    union = jnp.sum(pred) + jnp.sum(target) - inter
    return 1.0 - inter / (union + 1e-8)


def make_adam_step(loss_fn: Callable, optimizer):
    """Shared jitted train step over any optax-compatible params pytree:
    returns (params, opt_state, {loss, grad_norm}).

    Extra pytree arguments of `loss_fn` (e.g. the target grid) are
    passed through `step(params, opt_state, *aux)` — as jit ARGUMENTS,
    so large arrays don't embed as program constants."""

    @jax.jit
    def step(params, opt_state, *aux):
        value, grads = jax.value_and_grad(loss_fn)(params, *aux)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {
            "loss": value,
            "grad_norm": optax.global_norm(grads),
        }

    return step


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FitState:
    coords: jnp.ndarray
    opt_state: object
    step: jnp.ndarray

    def tree_flatten(self):
        return (self.coords, self.opt_state, self.step), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)


class VoxelFit:
    """Adam-based vertex fitting of a template mesh to a target grid.

    Plan staleness guard: the soft plan's raster windows only cover
    vertex motion up to the plan's pad window; beyond that, coverage
    silently erodes (`voxtpu.ops.soft_vox.make_soft_plan`). `step()`
    checks drift every `refresh_every` steps (the check is one scalar
    device read) and rebuilds the plan from the current coordinates when
    max displacement exceeds ``drift_limit_frac * pad_window`` voxels.
    Pass ``refresh_every=0`` to manage refreshes manually via
    :meth:`maybe_refresh_plan`.
    """

    def __init__(
        self,
        plan,
        target_occ: jnp.ndarray,
        learning_rate: float = 1e-2,
        tau_edge_frac: float = 0.5,
        tau_x_frac: float = 0.5,
        loss_fn: Callable = soft_iou_loss,
        refresh_every: int = 8,
        drift_limit_frac: float = 0.5,
    ):
        self.plan = plan
        self.target = jnp.asarray(target_occ, jnp.float32)
        self.optimizer = optax.adam(learning_rate)
        self._tau = (tau_edge_frac, tau_x_frac)
        self._loss_fn = loss_fn
        self.refresh_every = refresh_every
        self.drift_limit_vox = drift_limit_frac * getattr(plan, "pad_window", 1)
        self.refresh_count = 0
        self._steps_seen = 0
        pc = getattr(plan, "plan_coords", None)
        self._plan_coords = None if pc is None else jnp.asarray(pc)
        self._rebuild_step()

    def _rebuild_step(self):
        te, tx = self._tau
        plan = self.plan

        # The target grid is a step ARGUMENT: closure capture would embed
        # the full N^3 float32 array as an HLO constant and re-embed it
        # on every plan-refresh recompile.
        def loss(coords, target):
            occ = soft_voxelize(coords, plan, tau_edge_frac=te,
                                tau_x_frac=tx)
            return self._loss_fn(occ, target)

        self._loss_aux = (self.target,)
        self._loss = lambda c: loss(c, self.target)
        self._adam_step = make_adam_step(loss, self.optimizer)

    def drift_voxels(self, coords) -> jnp.ndarray:
        """Max vertex displacement since the plan was built, in voxels."""
        if self._plan_coords is None:
            return jnp.float32(0.0)
        # One jitted dispatch instead of a chain of eager ops: this runs
        # on every fit step.
        return _max_drift(coords, self._plan_coords,
                          jnp.float32(self.plan.spec.voxel_size))

    def maybe_refresh_plan(self, state: FitState, force: bool = False) -> bool:
        """Rebuild the soft plan if vertices drifted past the pad window."""
        if not force and float(self.drift_voxels(state.coords)) <= self.drift_limit_vox:
            return False
        from voxtpu.ops.soft_vox import refresh_soft_plan

        self.plan = refresh_soft_plan(self.plan, state.coords)
        self._plan_coords = jnp.asarray(state.coords)
        self.refresh_count += 1
        self._rebuild_step()
        return True

    def step(self, state: FitState):
        self._steps_seen += 1
        if self.refresh_every and self._steps_seen % self.refresh_every == 0:
            self.maybe_refresh_plan(state)
        coords, opt_state, metrics = self._adam_step(
            state.coords, state.opt_state, *self._loss_aux)
        metrics["max_drift_vox"] = self.drift_voxels(coords)
        return (
            FitState(coords=coords, opt_state=opt_state, step=state.step + 1),
            metrics,
        )

    def init(self, coords) -> FitState:
        coords = jnp.asarray(coords, jnp.float32)
        if self._plan_coords is None:
            # Plans built before the drift guard don't record their build
            # coordinates; treat the fit's start point as the reference.
            self._plan_coords = coords
        return FitState(
            coords=coords,
            opt_state=self.optimizer.init(coords),
            step=jnp.zeros((), jnp.int32),
        )

    # -- checkpoint / resume (aux subsystem; no reference analog — the
    # CUDA CLI is batch-only, SURVEY.md §5 "checkpoint: not present") --

    def save_checkpoint(self, path, state: FitState) -> None:
        """Persist (coords, opt_state, step, plan fingerprint) to one
        .npz. Restoring with :meth:`load_checkpoint` on a VoxelFit built
        with the same optimizer resumes bit-identically (tested)."""
        import numpy as _np

        leaves = jax.tree_util.tree_leaves(
            (state.coords, state.opt_state, state.step))
        payload = {f"leaf_{i}": _np.asarray(v) for i, v in enumerate(leaves)}
        payload["plan_coords"] = _np.asarray(
            self._plan_coords if self._plan_coords is not None
            else state.coords)
        payload["bookkeeping"] = _np.asarray(
            [self._steps_seen, self.refresh_count], _np.int64)
        _np.savez(path, **payload)

    def load_checkpoint(self, path) -> FitState:
        """Rebuild a FitState from :meth:`save_checkpoint` output.

        The optimizer-state tree structure is recovered by flattening a
        freshly initialized state with this fit's own optimizer, so the
        checkpoint stays a plain array bundle (no pickled treedefs). If
        the saved plan fingerprint differs from this fit's plan, the
        plan is refreshed from the restored coordinates."""
        import numpy as _np

        data = _np.load(path)
        nleaves = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(nleaves)]
        coords_t = leaves[0]
        template = (coords_t, self.optimizer.init(coords_t),
                    jnp.zeros((), jnp.int32))
        treedef = jax.tree_util.tree_structure(template)
        coords, opt_state, step = jax.tree_util.tree_unflatten(
            treedef, leaves)
        saved_pc = jnp.asarray(data["plan_coords"])
        seen, refreshed = (int(x) for x in data["bookkeeping"])
        self._steps_seen = seen
        self.refresh_count = refreshed
        state = FitState(coords=coords, opt_state=opt_state, step=step)
        # Stale-plan guard: drift must be measured against THIS fit's
        # plan (self._plan_coords describes self.plan — overwriting it
        # with the checkpoint's fingerprint first would compare the
        # restored coords against a plan this fit doesn't hold). Refresh
        # when the checkpoint was taken under a different plan, or when
        # the restored coords exceed this plan's coverage.
        if self._plan_coords is None:
            self._plan_coords = saved_pc
        same_plan = (self._plan_coords.shape == saved_pc.shape
                     and bool(jnp.all(self._plan_coords == saved_pc)))
        if (not same_plan
                or float(self.drift_voxels(coords)) > self.drift_limit_vox):
            self.maybe_refresh_plan(state, force=True)
        return state

    def loss(self, coords) -> jnp.ndarray:
        return self._loss(jnp.asarray(coords, jnp.float32))

    def forward(self, coords) -> jnp.ndarray:
        return soft_voxelize(
            jnp.asarray(coords, jnp.float32), self.plan,
            tau_edge_frac=self._tau[0], tau_x_frac=self._tau[1],
        )
