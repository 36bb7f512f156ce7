"""Checkpointing: npz + JSON manifest, async save, plans first-class.

Layout (the reference's, ``src/repro/checkpoint/ckpt.py``, so a directory
written by either package restores in the other):

  <dir>/step_<N>/manifest.json   {step, n_leaves, tree structure}
  <dir>/step_<N>/leaf_<i>.npy    one array per leaf (host-gathered)
  <dir>/step_<N>/plan_<name>/    a persisted InteractionPlan (save_plan):
                                 arrays.npz (BSR tiles + permutation + COO
                                 + embedding frame + streaming state) and
                                 manifest.json (config, tree levels,
                                 refresh telemetry)
  .../plan_<name>/member_<i>/    one member of a persisted PlanBatch, in
                                 the single-plan format
  .../plan_<name>/session_<rid>/ one session of a persisted SessionStore:
                                 layer_<l>/ (a batch) + aux.npz

Design points:
  - saves are ASYNC (a background thread; ``wait()`` joins, and the next
    save joins first). Everything is gathered to host memory *before*
    ``save``/``save_plan`` returns: the port's storage primitives write in
    place (``blocksparse.patch_bsr``, ``transformer.decode_step``), so a
    copy taken later on the worker could race with them;
  - atomicity: writes land in a ``.tmp`` directory that is renamed at the
    end, so a crash mid-save never corrupts the latest complete step;
  - plans are first-class: a serving restart calls ``restore_plan``
    instead of re-running kNN -> embedding -> tree -> ordering -> BSR, and
    ``restore_plan(refresh_with=x)`` re-validates the stored ordering
    against the current points through ``api.refresh_plan``;
  - restore reuses ``convert.plan_from_reference_arrays``, the one entry
    that rebuilds a port plan from arrays (and checks them);
  - backend names cross through ``convert``'s two-way map (the port's
    ``cuda`` is saved as the reference's ``pallas``); a reference bf16
    array (``|V2`` in an npz) is read as ``torch.bfloat16``; the port
    writes bf16 as float32 (lossless), as the reference does;
  - devices: ``restore``/``restore_plan`` take ``device=None``, meaning
    the card, as every entry point does;
  - shard-aware: ``save_plan`` of a ``ShardedPlan`` writes the unsharded
    plan plus a note of its axis, and ``restore_plan(mesh=)`` re-shards on
    load (elastic: the halo analysis runs against the restoring mesh).
    Placing a model tree over a mesh (``restore(shardings=)``) waits for
    the mesh half of training, ROADMAP A14b.

When saving a model tree and a plan at the same step, save the model tree
first: ``save(step, ...)`` replaces the whole ``step_<N>`` directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (placing a model tree over a mesh) is not ported to "
        "repro_torch yet (port queue item A14b in ROADMAP.md)")


def _host(a) -> np.ndarray:
    """A host copy of a tensor or array that no later in-place write can
    reach; bfloat16 becomes float32 (lossless; numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.to("cpu", copy=True).numpy()
    return np.array(a)


# ---------------------------------------------------------------------------
# model trees: jax.tree.flatten's leaf order, without JAX
# ---------------------------------------------------------------------------


def _flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves of a nested dict/list/tuple tree in ``jax.tree.flatten``'s
    order (dict keys sorted, sequences in order, ``None`` holds no leaf)
    and a skeleton with ``None`` in the leaves' places."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return len(leaves) - 1
    return leaves, walk(tree)


def _unflatten(skeleton, leaves: List[Any]):
    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return leaves[t]
    return walk(skeleton)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros(1, np.asarray(leaf).dtype)).dtype


# ---------------------------------------------------------------------------
# plans: the single-plan, batch and session-store payloads
# ---------------------------------------------------------------------------


def _validate_plan_arrays(m: dict, arrays: dict, where) -> None:
    """Cross-check a plan manifest against its array payload before any
    reconstruction: a truncated/mismatched checkpoint fails here with a
    message naming the offending array, not deep in BSR math."""
    n = m.get("n")
    required = ["pi", "inv"]
    if m.get("bsr") is not None:
        required += ["bsr_col_idx", "bsr_nbr_mask", "bsr_vals"]
    missing = [k for k in required if k not in arrays]
    if missing:
        raise ValueError(
            f"plan checkpoint {where} is missing arrays {missing} "
            f"(manifest promises them)")
    for key in ("pi", "inv", "alive", "codes"):
        if key in arrays and len(arrays[key]) != n:
            raise ValueError(
                f"plan checkpoint {where}: array {key!r} has "
                f"{len(arrays[key])} entries, manifest says capacity "
                f"n={n}")
    if m.get("bsr") is not None:
        b = m["bsr"]
        want = (b["n_rb"], b["max_nbr"], b["bs"], b["bs"])
        got = arrays["bsr_vals"].shape
        if got != want:
            raise ValueError(
                f"plan checkpoint {where}: bsr_vals shape {got} does not "
                f"match the manifest BSR layout {want}")
        if arrays["bsr_col_idx"].shape != want[:2]:
            raise ValueError(
                f"plan checkpoint {where}: bsr_col_idx shape "
                f"{arrays['bsr_col_idx'].shape} does not match the "
                f"manifest BSR layout {want[:2]}")
    if "coo_rows" in arrays:
        lens = {k: len(arrays[k]) for k in
                ("coo_rows", "coo_cols", "coo_vals") if k in arrays}
        if len(set(lens.values())) > 1 or len(lens) != 3:
            raise ValueError(
                f"plan checkpoint {where}: COO triple is ragged or "
                f"incomplete ({lens})")


_HOST_KEYS = ("embedding", "y_last", "embed_mean", "embed_axes", "sources",
              "x", "alive", "codes", "code_lo", "code_hi")


def _plan_payload(plan, step: int):
    """Host-gather one ``InteractionPlan`` into ``(arrays, manifest)`` —
    the single-plan on-disk format (shared by batch members)."""
    from repro_torch import convert

    host = plan.host
    arrays = {"pi": np.array(host.pi), "inv": np.array(host.inv)}
    if plan.bsr is not None:
        arrays["bsr_col_idx"] = _host(plan.bsr.col_idx)
        arrays["bsr_nbr_mask"] = _host(plan.bsr.nbr_mask)
        arrays["bsr_vals"] = _host(plan.bsr.vals)
    if host.coo is not None:
        arrays["coo_rows"], arrays["coo_cols"], arrays["coo_vals"] = (
            np.array(a) for a in host.coo)
    for key in _HOST_KEYS:
        val = getattr(host, key)
        if val is not None:
            arrays[key] = np.array(val)
    if host.tree is not None:
        arrays["tree_perm"] = np.array(host.tree.perm)
        for i, lvl in enumerate(host.tree.levels):
            arrays[f"tree_level_{i}"] = np.array(lvl)
    manifest = {
        "format": 1,
        "step": step,
        "n": plan.n,
        # streaming capacity layout: capacity == n (physical slots);
        # n_alive is the logical live count the restored mask re-derives
        "capacity": plan.n,
        "n_alive": plan.n_alive,
        "peak_alive": host.peak_alive,
        "config": convert.config_to_reference(plan.config),
        "sigma": host.sigma,
        "gamma": host.gamma,
        "pattern_from_knn": host.pattern_from_knn,
        # a callable cannot round-trip: freeze the pattern on restore
        "values_mode": ("static" if host.values_mode == "fn"
                        else host.values_mode),
        "refresh": dataclasses.asdict(host.refresh),
        "bsr": (None if plan.bsr is None else {
            "bs": plan.bsr.bs, "sb": plan.bsr.sb, "n": plan.bsr.n,
            "n_rb": plan.bsr.n_rb, "n_cb": plan.bsr.n_cb,
            "fill": plan.bsr.fill, "max_nbr": plan.bsr.max_nbr}),
        "tree": (None if host.tree is None else {
            "d": host.tree.d, "bits": host.tree.bits,
            "n_levels": host.tree.n_levels}),
        "shard": None,
    }
    return arrays, manifest


def _plan_from_payload(m: dict, arrays: dict, device: DeviceLike):
    """Rebuild a single ``InteractionPlan`` from a validated ``(manifest,
    arrays)`` payload through ``convert.plan_from_reference_arrays``."""
    from repro_torch import convert
    from repro_torch.core.hierarchy import Tree

    b = m["bsr"]
    coo = (tuple(arrays[k] for k in ("coo_rows", "coo_cols", "coo_vals"))
           if "coo_rows" in arrays else None)
    t = m["tree"]
    levels = (None if t is None else
              [arrays[f"tree_level_{i}"] for i in range(t["n_levels"])])
    plan = convert.plan_from_reference_arrays(
        m["config"], m["n"], arrays["pi"], arrays["inv"], coo,
        None if b is None else arrays["bsr_col_idx"],
        None if b is None else arrays["bsr_nbr_mask"],
        None if b is None else arrays["bsr_vals"],
        m["sigma"], fill=0.0 if b is None else b["fill"],
        embedding=arrays.get("embedding"),
        embed_mean=arrays.get("embed_mean"),
        embed_axes=arrays.get("embed_axes"), tree_levels=levels,
        y_last=arrays.get("y_last"), x=arrays.get("x"),
        sources=arrays.get("sources"),
        pattern_from_knn=m["pattern_from_knn"],
        values_mode=m["values_mode"], refresh=m["refresh"],
        alive=arrays.get("alive"), codes=arrays.get("codes"),
        code_lo=arrays.get("code_lo"), code_hi=arrays.get("code_hi"),
        peak_alive=m.get("peak_alive"), device=device)
    if t is not None:
        # the tree as saved (its own permutation, d and bits)
        plan.host.tree = Tree(perm=arrays["tree_perm"], levels=levels,
                              d=t["d"], bits=t["bits"])
    plan.host.gamma = m["gamma"]
    return plan


def _batch_payload(pb, step: int):
    """Host-gather one ``PlanBatch`` into ``(member_payloads, manifest)``
    — the on-disk batch format (also each layer of a session store)."""
    from repro_torch import convert

    payloads = [_plan_payload(pb.member(i), step) for i in range(pb.batch)]
    manifest = {
        "format": 1, "step": step, "batch": pb.batch,
        "capacity": pb.capacity,
        "config": convert.config_to_reference(pb.spec.config),
        # the reference's per-ndim auto winners; the port keeps its
        # decisions in core.autotune's memo instead
        "tuned": {},
    }
    return payloads, manifest


def _write_batch_dir(d: Path, payloads, manifest: dict) -> None:
    for i, (arrays, m) in enumerate(payloads):
        sub = d / f"member_{i}"
        sub.mkdir()
        np.savez(sub / "arrays.npz", **arrays)
        (sub / "manifest.json").write_text(json.dumps(m))
    (d / "manifest.json").write_text(json.dumps(manifest))


def _load_npz(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _read_batch_dir(d: Path, m: dict, device: DeviceLike):
    """Restore a ``PlanBatch`` from a dir written by ``_write_batch_dir``
    (members re-stacked, so the shared spec is re-derived). A reference
    batch's ``"tuned"`` map is ignored."""
    from repro_torch import api

    members = []
    for i in range(m["batch"]):
        sub = d / f"member_{i}"
        try:
            mm = json.loads((sub / "manifest.json").read_text())
            arrays = _load_npz(sub / "arrays.npz")
        except Exception as e:
            raise ValueError(
                f"plan batch member {i} is corrupt or missing under "
                f"{sub}: {e}") from e
        _validate_plan_arrays(mm, arrays, sub)
        members.append(_plan_from_payload(mm, arrays, device))
    return api.PlanBatch.from_plans(members, capacity=m["capacity"])


class Checkpointer:
    """Atomic, async checkpointing of model trees and plans.

    ``save(step, tree)`` host-gathers the tree (dicts, lists, tuples of
    tensors or arrays) before it returns and writes it on a background
    thread (``wait()`` joins; the next save joins first). Writes land in a
    ``.tmp`` directory renamed at the end, so a crash mid-save never
    corrupts the latest complete step. ``save_plan``/``restore_plan``
    persist :class:`~repro_torch.api.InteractionPlan`, ``PlanBatch`` and
    ``serve.SessionStore`` lineages (storage, ordering, streaming state,
    refresh telemetry) so serving restarts skip the embed -> tree -> order
    -> compress pipeline. The last ``keep`` steps of each kind are kept.
    """

    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Host-gather the tree now and write it in the background."""
        self.wait()
        flat, skeleton = _flatten(tree)
        host = [_host(x) for x in flat]

        def work():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, arr in enumerate(host):
                np.save(tmp / f"leaf_{i}.npy", arr)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": repr(skeleton)}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self._run(work, blocking)

    def _run(self, work, blocking: bool) -> None:
        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        # model checkpoints and plans may be saved on different cadences:
        # keep the latest `keep` of EACH kind (a step dir survives if
        # either its model tree or its plan is still wanted)
        keep_model = set(self.steps()[-self.keep:])
        keep_plan = set(self.plan_steps()[-self.keep:])
        for p in self.dir.glob("step_*"):
            s = int(p.name.split("_")[1])
            if s not in keep_model and s not in keep_plan:
                shutil.rmtree(p, ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self):
        """Steps holding a *model* checkpoint (plan-only steps excluded, so
        ``restore()``'s default step never lands on a dir with no leaves)."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def plan_steps(self, name: Optional[str] = None):
        """Steps holding a persisted plan (``name`` filters to one plan)."""
        pattern = f"plan_{name}/manifest.json" if name else \
            "plan_*/manifest.json"
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*") if any(p.glob(pattern)))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None,
                device: DeviceLike = None) -> Tuple[Any, int]:
        """Restore into the structure of ``tree_like``: every leaf a tensor
        on ``device`` (``None``: the card) in that leaf's dtype."""
        if shardings is not None:
            raise _not_ported("restore(shardings=)")
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        flat, skeleton = _flatten(tree_like)
        n = json.loads((d / "manifest.json").read_text())["n_leaves"]
        if n != len(flat):
            raise ValueError(f"checkpoint has {n} leaves, model needs "
                             f"{len(flat)} — structure mismatch")
        from repro_torch import convert

        out = []
        for i, leaf in enumerate(flat):
            a = convert.array_from_reference(np.load(d / f"leaf_{i}.npy"))
            out.append(from_numpy(a, dev).to(_torch_dtype(leaf))
                       .reshape(tuple(a.shape)))
        return _unflatten(skeleton, out), step

    # -- interaction plans ----------------------------------------------------

    def save_plan(self, step: int, plan: Any, name: str = "plan",
                  blocking: bool = False) -> None:
        """Persist an ``InteractionPlan``, a ``ShardedPlan`` (its unsharded
        plan, with the sharding axis noted for ``restore_plan(mesh=)``), a
        ``PlanBatch`` or a ``serve.SessionStore``, gathered to the host
        before this returns.

        BSR arrays, permutation, COO pattern, embedding frame and
        streaming state are stored exactly (the restored plan's ``matvec``
        is bit-identical); config, tree levels and refresh telemetry ride
        in the JSON manifest. A ``values`` *callable* cannot be serialized:
        the restored plan refreshes in pattern-frozen (reorder-only) mode.
        A batch lands as ``member_<i>/`` in the single-plan format under
        one batch manifest; a session store as ``session_<rid>/`` with one
        batch directory per layer, its ``aux.npz`` payload and a session
        manifest, under a top manifest of rids and service counters.
        """
        self.wait()
        if hasattr(plan, "sessions") and hasattr(plan, "counters"):
            store = plan
            entries = []
            for rid in sorted(store.sessions):
                sess = store.sessions[rid]
                layers = [_batch_payload(pb, step) for pb in sess.plans]
                aux = {k: _host(v) for k, v in sess.aux.items()}
                sman = {"rid": sess.rid, "slot": sess.slot,
                        "blen": sess.blen, "n_layers": len(sess.plans)}
                entries.append((rid, layers, aux, sman))
            manifest = {
                "format": 1, "step": step, "session_store": True,
                "rids": sorted(store.sessions),
                "counters": dict(store.counters),
            }

            def fill(tmp: Path) -> None:
                for rid, layers, aux, sman in entries:
                    sd = tmp / f"session_{rid}"
                    sd.mkdir()
                    for l, (payloads, bman) in enumerate(layers):
                        ld = sd / f"layer_{l}"
                        ld.mkdir()
                        _write_batch_dir(ld, payloads, bman)
                    np.savez(sd / "aux.npz", **aux)
                    (sd / "manifest.json").write_text(json.dumps(sman))
                (tmp / "manifest.json").write_text(json.dumps(manifest))
        elif hasattr(plan, "hosts") and hasattr(plan, "member"):
            payloads, manifest = _batch_payload(plan, step)

            def fill(tmp: Path) -> None:
                _write_batch_dir(tmp, payloads, manifest)
        else:
            shard_meta = None
            if hasattr(plan, "spec") and hasattr(plan, "unshard"):
                # a ShardedPlan: the unsharded plan lands on disk (the
                # shards are a pure transform of it)
                shard_meta = {"axis": plan.spec.axis,
                              "n_dev": plan.spec.n_dev,
                              "mode": plan.spec.mode}
                plan = plan.plan
            arrays, manifest = _plan_payload(plan, step)
            manifest["shard"] = shard_meta

            def fill(tmp: Path) -> None:
                np.savez(tmp / "arrays.npz", **arrays)
                (tmp / "manifest.json").write_text(json.dumps(manifest))

        self._write_plan_dir(step, name, fill, blocking)

    def _write_plan_dir(self, step: int, name: str, fill,
                        blocking: bool) -> None:
        """The atomic plan-write dance: populate a ``.tmp`` dir via
        ``fill(tmp)``, rename it into place, garbage-collect — in the
        background unless blocking."""

        def work():
            tmp = self.dir / f".tmp_plan_{step}_{name}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            fill(tmp)
            final = self.dir / f"step_{step}" / f"plan_{name}"
            final.parent.mkdir(parents=True, exist_ok=True)
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self._run(work, blocking)

    def restore_plan(self, step: Optional[int] = None, name: str = "plan",
                     refresh_with: Any = None,
                     policy: Optional[str] = None,
                     mesh: Any = None, axis: Optional[str] = None,
                     device: DeviceLike = None) -> Tuple[Any, int]:
        """Restore what :meth:`save_plan` (of either package) wrote, on
        ``device`` (``None``: the card).

        With ``refresh_with`` (the *current* points, original order), the
        restored plan is passed through ``api.refresh_plan`` (``policy``
        as there): the recorded cell/γ-drift policy decides whether the
        persisted ordering still stands, gets patched, or is rebuilt.

        With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`, or
        ``"auto"`` for ``default_mesh`` on ``device``'s type), the plan is
        re-sharded after any refresh and a ``ShardedPlan`` is returned;
        the halo analysis runs against the *restoring* mesh's device
        count. ``axis`` defaults to a one-axis mesh's axis, else the
        recorded sharding axis (or ``"data"``).
        """
        from repro_torch import api, convert
        from repro_torch.launch.mesh import Mesh, default_mesh

        if mesh is not None and not (
                isinstance(mesh, Mesh) or mesh == "auto"):
            raise TypeError(
                f"mesh must be a repro_torch.launch.mesh.Mesh or 'auto', "
                f"got {mesh!r} — restore_plan re-shards elastically on "
                "whatever mesh you pass")
        if isinstance(mesh, Mesh) and axis is not None \
                and axis not in mesh.shape:
            raise ValueError(
                f"restoring mesh has no axis {axis!r} (axes: "
                f"{tuple(mesh.axis_names)}, {mesh.size} devices)")
        dev = resolve_device(device)
        if step is None:
            ps = self.plan_steps(name)
            step = ps[-1] if ps else None
        if step is None:
            raise FileNotFoundError(f"no plan {name!r} under {self.dir}")
        d = self.dir / f"step_{step}" / f"plan_{name}"
        if not (d / "manifest.json").exists():
            raise FileNotFoundError(f"no plan {name!r} at step {step} "
                                    f"under {self.dir}")
        try:
            m = json.loads((d / "manifest.json").read_text())
        except ValueError as e:
            raise ValueError(
                f"corrupt plan manifest {d / 'manifest.json'}: {e} "
                "(checkpoint writes are atomic — this directory was "
                "modified outside the Checkpointer)") from e
        if m.get("session_store"):
            if refresh_with is not None or mesh is not None:
                raise ValueError(
                    f"plan {name!r} at step {step} is a SessionStore; "
                    "refresh_with/mesh apply to single plans")
            from repro_torch.serve.session import Session, SessionStore

            store = SessionStore()
            for rid in m["rids"]:
                sd = d / f"session_{rid}"
                try:
                    sman = json.loads((sd / "manifest.json").read_text())
                    aux = {k: convert.array_from_reference(v)
                           for k, v in _load_npz(sd / "aux.npz").items()}
                except Exception as e:
                    raise ValueError(
                        f"session store {name!r} at step {step}: session "
                        f"{rid} is corrupt or missing under {sd}: {e}"
                    ) from e
                plans = []
                for l in range(sman["n_layers"]):
                    ld = sd / f"layer_{l}"
                    bm = json.loads((ld / "manifest.json").read_text())
                    plans.append(_read_batch_dir(ld, bm, dev))
                # register, not admit: restoring is not an admission
                store.register(Session(rid=sman["rid"], slot=sman["slot"],
                                       blen=sman["blen"], plans=plans,
                                       aux=aux))
            store.counters = dict(m["counters"])
            return store, step
        if m.get("batch"):
            if refresh_with is not None or mesh is not None:
                raise ValueError(
                    f"plan {name!r} at step {step} is a PlanBatch; "
                    "refresh_with/mesh apply to single plans — restore the "
                    "batch plain and refresh/shard members individually")
            return _read_batch_dir(d, m, dev), step
        if not (d / "arrays.npz").exists():
            raise FileNotFoundError(
                f"plan {name!r} at step {step} has a manifest but no "
                f"arrays.npz under {d}")
        try:
            arrays = _load_npz(d / "arrays.npz")
        except Exception as e:
            raise ValueError(
                f"corrupt plan arrays {d / 'arrays.npz'}: {e}") from e
        _validate_plan_arrays(m, arrays, d)
        plan = _plan_from_payload(m, arrays, dev)
        if refresh_with is not None:
            plan = api.refresh_plan(plan, refresh_with, policy=policy)
        if mesh is not None:
            if axis is None and mesh != "auto" and len(mesh.axis_names) == 1:
                axis = mesh.axis_names[0]
            axis = axis or (m.get("shard") or {}).get("axis") or "data"
            if mesh == "auto":
                mesh = default_mesh(axis, dev)
            plan = api.shard(plan, mesh, axis=axis)
        return plan, step
