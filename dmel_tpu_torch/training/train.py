"""Training loop with early stopping, checkpoints and metric reporting
(counterpart of ``dmel_tpu/training/train.py``).

BCE on the sigmoid output (PANNs) or CE on the logits (the probes), a
per-epoch valid pass, early stopping on valid loss with patience, the
divergence stop and the 8-metric record per epoch.  In optimized mode
the window bucket and the dispatch hint are re-selected from the
current lambda at each epoch boundary (``bucket_update="epoch"``) or
before every step (``bucket_update="step"``, one read of lambda a
step).  The ragged tail
batch is padded and masked.  Dropout masks come from one seeded
``torch.Generator`` on the device; metrics stay on the device and are
read once per epoch.  Batches are sliced and placed on the device
``prefetch`` batches ahead on a background thread (the config's
``prefetch`` key, default 2, which the port reads because the JAX
package's ``fit`` reads it; 0 places them in the loop), through pinned
host memory and non-blocking copies on the loop's stream
(:func:`~dmel_tpu_torch.data.loader.device_batches`): the results do not
depend on it, and ``chip_smoke.py`` times one trial at 0 and at 2.

With ``checkpoint_dir``, ``fit`` writes what the JAX package's does:

- ``best_model`` whenever the valid loss improves (the model's state
  dict, with its batch-norm statistics, and the optimizer's), with its
  geometry sidecar ``best_model.meta.json`` (the window length and hint
  the epoch ran at, and the epoch);
- ``live_state`` every ``live_checkpoint_every`` epochs (the model, the
  optimizer, the dropout generator's state and the loop's bookkeeping
  with the records), from which a killed trial resumes at its next
  epoch, bit-identical to an uninterrupted run; it is removed when the
  trial ends.

``pretrained_state_dict`` (a PANNs Cnn6 checkpoint's weights) is
imported into the fresh model before its optimizer is built
(:func:`~dmel_tpu_torch.training.checkpoint.import_panns_cnn6`).  Not
ported yet, and refused with ``NotImplementedError``: data parallelism
(``mesh``).
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dmel_tpu_torch.data.loader import BatchLoader, device_batches
from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.models.registry import (dispatch_hint_for,
                                            get_model_by_config,
                                            n_classes_for)
from dmel_tpu_torch.ops.spectrogram import bucketed_window_length
from dmel_tpu_torch.precision import precision_scope
from dmel_tpu_torch.training.checkpoint import (import_panns_cnn6,
                                                load_checkpoint,
                                                save_checkpoint)
from dmel_tpu_torch.training.optim import build_optimizer

BCE_LOG_FLOOR = -100.0  # torch binary_cross_entropy clamps log at -100


def _masked_mean(per_row: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(per_row.dtype)
    return (per_row * m).sum() / m.sum().clamp_min(1)


def bce_loss(probs: torch.Tensor, one_hot_labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """``binary_cross_entropy`` (mean over classes, then over the rows
    ``mask`` keeps).  The logs are guarded with ``where`` rather than
    clamped, so that probabilities of exactly 0 or 1 give the forward
    value of torch's clamp at -100 and a finite gradient."""
    p_lo = math.exp(-100.0)                   # log(p) == -100 boundary
    lo = probs > p_lo
    logp = torch.where(lo, torch.log(torch.where(lo, probs, 1.0)),
                       BCE_LOG_FLOOR)
    hi = probs < 1.0
    log1mp = torch.where(hi, torch.log1p(-torch.where(hi, probs, 0.0)),
                         BCE_LOG_FLOOR)
    per_elem = -(one_hot_labels * logp + (1 - one_hot_labels) * log1mp)
    return _masked_mean(per_elem.mean(dim=-1), mask)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy on integer labels over the kept rows."""
    per_row = F.cross_entropy(logits, labels.long(), reduction="none")
    return _masked_mean(per_row, mask)


def loss_and_metrics(model: torch.nn.Module, xs: torch.Tensor,
                     ys: torch.Tensor, mask: torch.Tensor, *,
                     one_hot: bool, n_classes: int,
                     generator: Optional[torch.Generator] = None):
    """``(loss, acc, energy)`` of one batch in the model's current mode.

    ``one_hot`` models (PANNs) output probabilities and take BCE on
    one-hot labels; the others output logits and take CE.  Multi-hot
    float labels ``ys`` (B, n_classes) take BCE (from logits where the
    model outputs logits) and count a hit when the argmax is a true
    label.  ``energy`` is the sum of the features over the kept rows.
    """
    logits, s = model(xs, generator=generator)
    preds = logits.argmax(dim=-1)
    if ys.dim() == 2:
        y = ys.to(logits.dtype)
        if one_hot:
            loss = bce_loss(logits, y, mask)
        else:
            loss = _masked_mean(F.binary_cross_entropy_with_logits(
                logits, y, reduction="none").mean(dim=-1), mask)
        acc = _masked_mean(ys.gather(-1, preds[:, None])[:, 0]
                           .to(logits.dtype), mask)
    else:
        if one_hot:
            labels = F.one_hot(ys.long(), n_classes).to(logits.dtype)
            loss = bce_loss(logits, labels, mask)
        else:
            loss = ce_loss(logits, ys, mask)
        acc = _masked_mean((preds == ys).to(logits.dtype), mask)
    energy = (s * mask.to(s.dtype)[:, None, None, None]).sum()
    return loss, acc, energy


def train_step(model, optimizer, xs, ys, mask, *, one_hot: bool,
               n_classes: int, generator: Optional[torch.Generator] = None):
    """One training step: forward in train mode, backward, optimizer
    step.  Returns the step's metrics as detached device tensors."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, acc, energy = loss_and_metrics(model, xs, ys, mask,
                                         one_hot=one_hot,
                                         n_classes=n_classes,
                                         generator=generator)
    loss.backward()
    optimizer.step()
    return {"loss": loss.detach(), "acc": acc.detach(),
            "energy": energy.detach()}


def eval_step(model, xs, ys, mask, *, one_hot: bool, n_classes: int):
    """Eval-mode metrics of one batch, without gradients."""
    model.eval()
    with torch.no_grad():
        loss, acc, energy = loss_and_metrics(model, xs, ys, mask,
                                             one_hot=one_hot,
                                             n_classes=n_classes)
    return {"loss": loss, "acc": acc, "energy": energy, "n": mask.sum()}


def current_lambd(model: torch.nn.Module) -> float:
    """Scalar lambda estimate of the model's spectrogram layer: the mean
    of a multi-sigma layer's vector."""
    return float(model.spectrogram_layer.lambd.detach().mean())


def _fetch(metrics: list[dict], keys) -> dict:
    """Per-step metrics as Python floats, in one device-to-host copy."""
    if not metrics:
        return {k: [] for k in keys}
    host = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in metrics]).cpu().tolist()
    return {k: [row[i] for row in host] for i, k in enumerate(keys)}


def _save_best(checkpoint_dir: str, model, optimizer, geometry: dict):
    """``best_model`` and its geometry sidecar, each written atomically."""
    base = os.path.join(checkpoint_dir, "best_model")
    save_checkpoint(base, {"model": model.state_dict(),
                           "optimizer": optimizer.state_dict()})
    tmp = base + ".meta.json.tmp"
    with open(tmp, "w") as f:
        json.dump(geometry, f)
    os.replace(tmp, base + ".meta.json")


@precision_scope()
def fit(config: dict, trainset, validset, *, seed: int = 0, device=None,
        verbose: int = 0,
        report_fn: Optional[Callable[[dict], None]] = None,
        checkpoint_dir: Optional[str] = None,
        pretrained_state_dict: Optional[dict] = None, mesh=None):
    """Train the model of ``config`` on ``device`` (default ``cuda``);
    returns ``(state, history)``.

    ``state`` holds the ``model``, the ``optimizer`` and the geometry
    the model last validated at (``window_length``, ``lambd_hint``).
    ``history`` holds the summary keys of the JAX package's ``fit`` and
    a per-epoch ``records`` list.  ``seed`` seeds the weights, the
    shuffles and the dropout generator; ``pretrained_state_dict`` (a
    PANNs Cnn6 checkpoint's weights) replaces the seeded weights it maps
    to, before any live state is restored.  ``checkpoint_dir`` keeps the
    best model, its sidecar and the live state (module docstring); a
    ``live_state`` there resumes the trial.  ``history["init_lambd"]``
    is the model's lambda once any live state is restored: a resumed
    trial reports the lambda it resumed at, as the JAX package's does.
    Runs inside :func:`~dmel_tpu_torch.precision.precision_scope`.
    """
    if mesh is not None:
        raise NotImplementedError("fit: mesh is not ported yet")
    dev = resolve_device(device)
    one_hot = "panns" in config["model_name"]
    n_classes = n_classes_for(config["dataset_name"])
    max_epochs = int(config["max_epochs"])
    patience = int(config["patience"])
    batch_size = int(config["batch_size"])
    optimized = bool(config.get("optimized", False))
    per_step = optimized and config.get("bucket_update", "epoch") == "step"
    n_points = int(config["n_points"])
    prefetch = int(config.get("prefetch", 2))

    def bucket_for(lambd_value):
        if not optimized:
            return None
        return bucketed_window_length(lambd_value, n_points)

    def hint_for(wl, lambd_value):
        return dispatch_hint_for(config, wl, lambd_value)

    trainloader = BatchLoader(trainset, batch_size, shuffle=True, seed=seed)
    validloader = BatchLoader(validset, batch_size, shuffle=False)
    wl = bucket_for(float(config["init_lambd"]))
    hint = None
    model = get_model_by_config(config, window_length=wl, device=dev,
                                seed=seed)
    if pretrained_state_dict is not None:
        import_panns_cnn6(pretrained_state_dict, model, verbose=verbose >= 1)
    optimizer = build_optimizer(config, model)
    generator = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(one_hot=one_hot, n_classes=n_classes)

    history = {
        "best_valid_acc": 0.0,
        "best_valid_loss": np.inf,
        "init_lambd": None,         # set once any live state is restored
        "converged": False,
        "diverged": False,
        "records": [],
    }
    start_epoch = 0
    best_valid_acc, best_valid_loss = 0.0, np.inf
    best_lambd_est = current_lambd(model)
    patience_count = 0

    live_path = (os.path.join(checkpoint_dir, "live_state")
                 if checkpoint_dir is not None else None)
    live_every = int(config.get("live_checkpoint_every", 1))
    if live_path is not None and os.path.exists(live_path):
        live = load_checkpoint(live_path)
        model.load_state_dict(live["model"])
        optimizer.load_state_dict(live["optimizer"])
        generator.set_state(live["generator"])
        meta = live["meta"]
        start_epoch = meta["epoch"] + 1
        patience_count = meta["patience_count"]
        best_valid_acc = meta["best_valid_acc"]
        best_valid_loss = meta["best_valid_loss"]
        best_lambd_est = meta["best_lambd_est"]
        history["records"] = list(meta["records"])
        trainloader.set_epoch(start_epoch)
        if verbose >= 1:
            print(f"resuming trial at epoch {start_epoch} "
                  f"(live state: {live_path})")
    history["init_lambd"] = current_lambd(model)

    def save_live(epoch):
        if (live_path is None or live_every <= 0
                or (epoch + 1) % live_every != 0):
            return
        meta = dict(epoch=epoch, patience_count=patience_count,
                    best_valid_acc=best_valid_acc,
                    best_valid_loss=float(best_valid_loss),
                    best_lambd_est=best_lambd_est,
                    records=history["records"])
        save_checkpoint(live_path, {"model": model.state_dict(),
                                    "optimizer": optimizer.state_dict(),
                                    "generator": generator.get_state(),
                                    "meta": meta})

    for epoch in range(start_epoch, max_epochs):
        lam_now = current_lambd(model)
        if not np.isfinite(lam_now):
            # a NaN/inf loss cascade; record it and stop the trial (the
            # best checkpoint of the earlier epochs stays on disk)
            history["diverged"] = True
            if verbose >= 1:
                print(f"epoch {epoch}: lambda diverged (non-finite); "
                      "stopping trial")
            break
        wl = bucket_for(lam_now)
        hint = hint_for(wl, lam_now)
        model.spectrogram_layer.set_geometry(wl, hint)

        steps = []
        batches = device_batches(trainloader, dev, prefetch)
        try:
            for batch in batches:
                if per_step:
                    lam_now = current_lambd(model)
                    if not np.isfinite(lam_now):
                        break   # the next epoch's boundary records it
                    new_wl = bucket_for(lam_now)
                    new_hint = hint_for(new_wl, lam_now)
                    if (new_wl, new_hint) != (wl, hint):
                        wl, hint = new_wl, new_hint
                        model.spectrogram_layer.set_geometry(wl, hint)
                steps.append(train_step(model, optimizer, *batch,
                                        generator=generator, **kw))
        finally:
            batches.close()
        agg = _fetch(steps, ("loss", "energy"))
        count = len(steps)
        train_loss = sum(agg["loss"]) / max(count, 1)
        train_energy = sum(agg["energy"]) / max(count, 1)
        if verbose >= 1:
            print(f"epoch {epoch}, train loss = {train_loss}")
            print(f"est. lambd = {current_lambd(model)}")

        batches = device_batches(validloader, dev, prefetch)
        try:
            valid = [eval_step(model, *batch, **kw) for batch in batches]
        finally:
            batches.close()
        vagg = _fetch(valid, ("loss", "acc"))
        v_n = len(valid)
        valid_loss = sum(vagg["loss"]) / max(v_n, 1)
        valid_acc = sum(vagg["acc"]) / max(v_n, 1)

        if valid_loss < best_valid_loss:
            if checkpoint_dir is not None:
                # the sidecar holds the geometry this checkpoint was
                # validated at: a lambda that crossed a bucket edge
                # during the epoch must not pick another at test time
                _save_best(checkpoint_dir, model, optimizer,
                           {"window_length": wl, "lambd_hint": hint,
                            "epoch": epoch})
            best_valid_acc = valid_acc
            best_valid_loss = valid_loss
            best_lambd_est = current_lambd(model)
            patience_count = 0
        else:
            patience_count += 1

        record = {
            "epoch": epoch,
            "loss": train_loss,
            "lambd_est": current_lambd(model),
            "valid_loss": valid_loss,
            "valid_acc": valid_acc,
            "best_valid_acc": best_valid_acc,
            "best_valid_loss": best_valid_loss,
            "energy": train_energy,
            "best_lambd_est": best_lambd_est,
        }
        lam_leaf = model.spectrogram_layer.lambd.detach()
        if lam_leaf.numel() > 1:
            # multi-sigma: each group's lambda; lambd_est stays the mean
            record["lambd_est_bands"] = lam_leaf.cpu().tolist()
        history["records"].append(record)
        if report_fn is not None:
            report_fn(record)
        if verbose >= 1:
            print(f"epoch {epoch}, valid loss = {valid_loss}, "
                  f"valid acc = {valid_acc}")

        save_live(epoch)

        if patience_count >= patience:
            if verbose >= 1:
                print("no more patience, break training loop ...")
            history["converged"] = True
            break

    history["best_valid_acc"] = best_valid_acc
    history["best_valid_loss"] = best_valid_loss
    history["est_lambd"] = current_lambd(model)
    # the trial ended (converged, diverged or out of epochs): the live
    # state is only for a trial killed mid-run
    if live_path is not None and os.path.exists(live_path):
        os.remove(live_path)
    state = {"model": model, "optimizer": optimizer,
             "window_length": wl, "lambd_hint": hint}
    return state, history


def predict(config: dict, state: dict, dataset, batch_size: int = 32,
            device=None):
    """Argmax predictions of ``state``'s model over ``dataset``; returns
    ``(labels, preds)`` as numpy arrays.

    The model is rebuilt at the geometry ``state`` records (the window
    length and hint it last validated at, as ``fit`` returns and the
    checkpoint sidecar keeps), with ``state["model"]``'s weights, on
    ``device`` (default ``cuda``).  A state without the geometry keys
    takes both from its lambda.
    """
    # a module-level import would be circular: eval -> experiments -> fit
    from dmel_tpu_torch.eval.predict import predict as predict_arrays
    weights = state["model"].state_dict()
    if "window_length" in state:
        wl, hint = state["window_length"], state.get("lambd_hint")
    else:
        lam = current_lambd(state["model"])
        wl = (bucketed_window_length(lam, int(config["n_points"]))
              if config.get("optimized", False) else None)
        hint = dispatch_hint_for(config, wl, lam)
    model = get_model_by_config(config, window_length=wl, lambd_hint=hint,
                                device=device)
    model.load_state_dict(weights)
    preds, _ = predict_arrays(model, dataset.xs, batch_size, device=device,
                              prefetch=int(config.get("prefetch", 2)))
    return np.asarray(dataset.ys), preds
