"""Packed multi-trial training (counterpart of
``dmel_tpu/parallel/trials.py``): K trials of one configuration family
trained as one program on one card.

The JAX package stacks the trials' parameters along a leading axis and
``jax.vmap``s its train step over it.  Here the stacked parameters live
in a :class:`~dmel_tpu_torch.models.packed.TrialPack`, whose forward
takes the trial axis explicitly: each front-end kernel, and each layer
of the model, runs once for the pack.  Per-trial hyperparameters
(``init_lambd``, ``lr_tf``, ``lr_model``, ``trainable``) become per-trial
rates of a scale-free optimizer
(:class:`~dmel_tpu_torch.training.optim.PackedOptimizer`), which for SGD
and Adam is each trial's own optimizer.

A ``mesh`` splits the trial axis over its ranks, as the JAX package's
``device_put`` onto ``P("data")`` does: each rank packs its contiguous
share of the trials, which never communicate.  The ranks share the
pack's hint, the loop's end and the histories; the pack-wide masks are
drawn on every rank, each keeping its trials' (a ``mesh_scope`` with
``axis="trial"``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from dmel_tpu_torch.data.loader import (BatchLoader, device_batches,
                                        stacked_batches)
from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.models.packed import TrialPack
from dmel_tpu_torch.models.registry import get_model_by_config, n_classes_for
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.ops.stft import pallas_compile_hint
from dmel_tpu_torch.distributed import all_gather_object, mesh_scope
from dmel_tpu_torch.precision import precision_scope
from dmel_tpu_torch.training.optim import PackedOptimizer
from dmel_tpu_torch.training.train import metrics_of

#: the keys every trial of a pack shares (the JAX package asserts them)
SHARED_KEYS = ("model_name", "dataset_name", "n_points", "hop_length",
               "batch_size", "max_epochs", "optimizer_name")


def _shared_specband_hint(c0: dict, wl, lambds, active=None):
    """The pack's one static ``lambd_hint``, or None: the JAX package's
    rule.  Only the auto dispatch (``impl="pallas"``) in optimized mode
    takes a hint; then every active trial's (finite) lambda must give the
    same :func:`~dmel_tpu_torch.ops.stft.pallas_compile_hint`, else None
    (frozen trials are ignored)."""
    if c0.get("impl") != "pallas" or wl is None:
        return None
    hints = []
    for i, lam in enumerate(lambds):
        if active is not None and not active[i]:
            continue
        if not np.isfinite(lam):
            return None
        hints.append(pallas_compile_hint(abs(float(lam)), wl,
                                         int(c0["hop_length"])))
    if not hints or any(h is None for h in hints):
        return None
    return hints[0] if all(h == hints[0] for h in hints) else None


def _lr_tree(params: dict, lr_tf: float, lr_model: float) -> dict:
    """Per-leaf rates of a model's parameters (names as in its
    ``state_dict``): ``lr_tf`` for every leaf under a ``lambd`` name,
    ``lr_model`` for the rest."""
    return {n: lr_tf if "lambd" in n.split(".") else lr_model
            for n in params}


def make_multitrial_step(pack: TrialPack, optimizer: PackedOptimizer,
                         one_hot: bool, n_classes: int):
    """The pack's train step: ``step(active, xs, ys, mask, generator)``
    with ``active`` (K,) 0/1 and the batch ``(K, B, ...)``, one forward,
    one backward and one optimizer update for every trial.  It returns
    the trials' ``loss``, ``acc`` and ``energy`` as (K,) device tensors.

    A trial with ``active`` 0 is frozen: its update is masked and its
    batch statistics are kept as they were (the JAX package's
    ``jnp.where(active > 0, new, old)``)."""
    metrics = torch.func.vmap(functools.partial(
        metrics_of, one_hot=one_hot, n_classes=n_classes))

    def step(active, xs, ys, mask, generator=None):
        pack.train()
        optimizer.zero_grad()
        # the statistics before the step, restored for inactive trials
        # below (a where on the card: no read of ``active`` on the host)
        old = {n: b.clone() for n, b in pack.buffers.items()}
        logits, s = pack(xs, generator)
        loss, acc, energy = metrics(logits, s, ys, mask)
        loss.sum().backward()
        optimizer.step(active)
        with torch.no_grad():
            for n, b in pack.buffers.items():
                keep = (active > 0).reshape((-1,) + (1,) * (b.dim() - 1))
                b.copy_(torch.where(keep, b, old[n]))
        return {"loss": loss.detach(), "acc": acc.detach(),
                "energy": energy.detach()}

    return step


def make_multitrial_eval(pack: TrialPack, one_hot: bool, n_classes: int):
    """The pack's eval step: ``evaluate(xs, ys, mask)`` on one batch
    ``(B, ...)`` shared by every trial, ``{"loss", "acc"}`` as (K,)
    device tensors, without gradients."""
    metrics = torch.func.vmap(functools.partial(
        metrics_of, one_hot=one_hot, n_classes=n_classes))

    def evaluate(xs, ys, mask):
        pack.eval()
        k = pack.k
        with torch.no_grad():
            logits, s = pack(xs.expand((k,) + xs.shape))
            loss, acc, _ = metrics(logits, s, ys.expand((k,) + ys.shape),
                                   mask.expand((k,) + mask.shape))
        return {"loss": loss, "acc": acc}

    return evaluate


def _mean_lambd(lam: torch.Tensor) -> np.ndarray:
    """Each trial's lambda estimate: the leaf, or its mean over sigma."""
    lam = lam.detach()
    if lam.dim() > 1:
        lam = lam.mean(dim=tuple(range(1, lam.dim())))
    return lam.cpu().numpy().astype(np.float64)


@precision_scope()
def fit_trials(configs: Sequence[dict], trainset, validset, *, mesh=None,
               seed: int = 0, device=None, verbose: int = 0):
    """Train K trials as one pack on ``device`` (default ``cuda``); returns
    ``(state, histories)``.

    The configs must share :data:`SHARED_KEYS` (else ``ValueError``)
    and may differ in ``init_lambd``, ``lr_tf``, ``lr_model``,
    ``trainable`` and ``patience``.  In optimized mode the pack's window
    bucket is the
    largest ``init_lambd``'s; its dispatch hint
    (:func:`_shared_specband_hint`) is re-derived at each epoch from the
    last lambdas of the active trials.  Trial i's weights are seeded with
    ``seed + i`` and its loader shuffled with ``seed + 13 i``; dropout and
    SpecAugment draw from one generator seeded with ``seed``.

    Each trial stops on its own patience: its ``active`` flag drops to
    0, which freezes its updates and batch statistics while the others
    train on, and the loop ends when no trial is active.  A trial keeps
    a best-on-valid-loss snapshot (``best_state``: its ``state_dict`` on
    the CPU, only its slice copied).  A frozen trial whose lambda
    diverged gets its last finite estimate back, so that no NaN enters
    the front end again (``diverged`` in its history).

    ``state`` holds the ``pack``, the ``optimizer``, the geometry of the
    last epoch (``window_length``, ``lambd_hint``) and the indices of the
    pack's ``trials``; each history holds ``records`` (one per epoch the
    trial was active), the best valid loss and accuracy, ``converged``,
    ``init_lambd`` and ``best_lambd_est``.  Runs inside
    :func:`~dmel_tpu_torch.precision.precision_scope`.

    ``mesh`` (a :class:`~dmel_tpu_torch.parallel.mesh.Mesh`) splits the
    trials over its ranks, on the mesh's device (``device`` unused): K
    must divide over the ranks (else ``ValueError``).  Each rank packs
    its contiguous share, trial i keeping its seeds by its index in
    ``configs``; every rank returns all K histories, and ``best_state``
    only in its own trials'.
    """
    k = len(configs)
    c0 = configs[0]
    for c in configs:
        for key in SHARED_KEYS:
            if c[key] != c0[key]:
                raise ValueError(f"trial configs differ in {key}")
    ranks = 1 if mesh is None else mesh.size
    if k % ranks:
        raise ValueError(f"{k} trials do not split over {ranks} ranks")
    dev = resolve_device(device) if mesh is None else mesh.device
    lo = 0 if mesh is None else mesh.rank * (k // ranks)
    ids = range(lo, lo + k // ranks)
    one_hot = "panns" in c0["model_name"]
    n_classes = n_classes_for(c0["dataset_name"])
    batch_size = int(c0["batch_size"])
    max_epochs = int(c0["max_epochs"])
    prefetch = int(c0.get("prefetch", 2 if ranks == 1 else 0))

    wl = None
    if c0.get("optimized", False):
        wl = max(bucketed_window_length(float(c["init_lambd"]),
                                        int(c0["n_points"]))
                 for c in configs)
    mine = [configs[i] for i in ids]
    pack = TrialPack([get_model_by_config(configs[i], window_length=wl,
                                          device=dev, seed=seed + i)
                      for i in ids])
    lrs = [_lr_tree(pack.params,
                    float(c["lr_tf"]) if c.get("trainable", True) else 0.0,
                    float(c["lr_model"])) for c in mine]
    lrs = {n: torch.tensor([lr[n] for lr in lrs], dtype=torch.float32,
                           device=dev) for n in pack.params}
    optimizer = PackedOptimizer(c0["optimizer_name"], pack.params, lrs)
    step = make_multitrial_step(pack, optimizer, one_hot, n_classes)
    evaluate = make_multitrial_eval(pack, one_hot, n_classes)
    generator = torch.Generator(device=dev).manual_seed(seed)

    # every trial's last lambda and active flag (all ranks'), from which
    # the pack's hint and the loop's end are decided alike on every rank
    lambds_all = np.asarray([float(c["init_lambd"]) for c in configs])
    active_all = np.ones(k, dtype=np.float32)
    loaders = [BatchLoader(trainset, batch_size, shuffle=True,
                           seed=seed + 13 * i) for i in ids]
    validloader = BatchLoader(validset, batch_size, shuffle=False)
    histories = [{"records": [], "best_valid_loss": np.inf,
                  "best_valid_acc": 0.0, "converged": False,
                  "init_lambd": float(c["init_lambd"]),
                  "best_lambd_est": float(c["init_lambd"])}
                 for c in mine]
    k = len(mine)                       # this rank's trials from here on
    patiences = np.asarray([int(c.get("patience", max_epochs))
                            for c in mine])
    patience_counts = np.zeros(k, dtype=int)
    active_np = np.ones(k, dtype=np.float32)
    hint = None
    lam_leaf = pack.params["spectrogram_layer.lambd"]

    for epoch in range(max_epochs):
        hint = _shared_specband_hint(c0, wl, lambds_all, active_all)
        pack.set_geometry(wl, hint)
        active = torch.tensor(active_np, device=dev)
        losses = []
        batches = device_batches(stacked_batches(loaders), dev, prefetch)
        try:
            with mesh_scope(mesh, "trial"):
                for xs, ys, mask in batches:
                    losses.append(step(active, xs, ys, mask,
                                       generator)["loss"])
        finally:
            batches.close()
        count = len(losses)
        sums = (torch.stack(losses).sum(0).cpu().numpy() if losses
                else np.zeros(k))

        valid = []
        batches = device_batches(validloader, dev, prefetch)
        try:
            for xs, ys, mask in batches:
                valid.append(evaluate(xs, ys, mask))
        finally:
            batches.close()
        v_n = len(valid)
        v_loss = (torch.stack([v["loss"] for v in valid]).sum(0).cpu()
                  .numpy() / v_n if valid else np.zeros(k))
        v_acc = (torch.stack([v["acc"] for v in valid]).sum(0).cpu()
                 .numpy() / v_n if valid else np.zeros(k))

        lambds = _mean_lambd(lam_leaf)
        lambds_host = lambds
        was_active = active_np.copy()
        for i, h in enumerate(histories):
            if active_np[i] and v_loss[i] < h["best_valid_loss"]:
                h["best_valid_loss"] = float(v_loss[i])
                h["best_valid_acc"] = float(v_acc[i])
                h["best_lambd_est"] = float(lambds[i])
                h["best_state"] = pack.trial_state_dict(i)
                patience_counts[i] = 0
            elif active_np[i]:
                patience_counts[i] += 1
                if patience_counts[i] >= patiences[i]:
                    active_np[i] = 0.0
                    h["converged"] = True
            if was_active[i]:
                h["records"].append({
                    "epoch": epoch,
                    "loss": float(sums[i] / max(count, 1)),
                    "valid_loss": float(v_loss[i]),
                    "valid_acc": float(v_acc[i]),
                    "lambd_est": float(lambds[i]),
                })
        # a frozen trial whose lambda diverged gets its last finite
        # estimate back: its updates are masked and its metrics dropped,
        # so the value is inert, and no NaN enters the front end again
        bad = [i for i in range(k)
               if not active_np[i] and not np.isfinite(lambds[i])]
        if bad:
            repl = lambds.copy()
            for i in bad:
                est = histories[i]["best_lambd_est"]
                repl[i] = est if np.isfinite(est) else 1.0
                histories[i]["diverged"] = True
            with torch.no_grad():
                rows = torch.tensor(repl, dtype=lam_leaf.dtype, device=dev)
                rows = rows.reshape((k,) + (1,) * (lam_leaf.dim() - 1))
                lam_leaf.copy_(torch.where(torch.isfinite(lam_leaf), lam_leaf,
                                           rows.expand_as(lam_leaf)))
            lambds_host = repl

        if verbose:
            print(f"epoch {epoch}: valid_acc={v_acc}, lambd={lambds}, "
                  f"active={active_np}")
        if mesh is not None:
            shares = all_gather_object((lambds_host, active_np), mesh)
            lambds_all = np.concatenate([lam for lam, _ in shares])
            active_all = np.concatenate([act for _, act in shares])
        else:
            lambds_all, active_all = lambds_host, active_np
        if not active_all.any():
            break

    if mesh is not None:
        own = histories
        shares = all_gather_object(
            [{n: v for n, v in h.items() if n != "best_state"}
             for h in own], mesh)
        histories = [h for share in shares for h in share]
        histories[lo:lo + k] = own
    state = {"pack": pack, "optimizer": optimizer, "window_length": wl,
             "lambd_hint": hint, "trials": list(ids)}
    return state, histories
