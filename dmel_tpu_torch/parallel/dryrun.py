"""The flagship model's forward and the multi-rank dry run, with a
launcher for the ranks (counterpart of the JAX package's
``__graft_entry__.py``).

- :func:`entry`: MelPANNsNet (DMEL + CNN6) at lambda 46.67 in eval mode,
  ``(forward, (x,))`` with logits of shape (4, 50).
- :func:`dryrun_multichip`: on every rank of a mesh, one data-parallel
  train step of a small mel probe, ``fit_trials`` with the trial axis
  over the ranks and a 3-epoch ``fit(mesh=...)`` whose lambda crosses
  window buckets.

The launcher starts the ranks on this machine::

    python -m dmel_tpu_torch.parallel.dryrun --nproc N --device cpu|cuda \\
        [--backend gloo|nccl] [--timeout S] [--jobs FILE] [--out DIR]

It binds port 0 for a free port, starts N processes of this module,
which join one process group over ``tcp://127.0.0.1:<port>`` (gloo on
the CPU, NCCL on CUDA unless ``--backend`` names another; a CPU rank
runs one torch thread), and waits.  A rank that fails, or the time
running out, kills every rank and makes the launcher exit non-zero.
Each rank runs the jobs of ``--jobs`` in order (a JSON list, by default
the dry run alone) and prints one ``RESULT <job> <json>`` line a job;
the launcher prints them as ``rank <r> <job> <json>``.  A job is a dict
whose ``"job"`` names one of :data:`JOBS` (the keys each reads are in
its docstring), with an optional ``"name"`` for its line and its files
under ``--out``.  Python callers use :func:`launch`, which returns the
ranks' results.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dmel_tpu_torch.data import ArrayDataset, get_dataset_by_config
from dmel_tpu_torch.data.loader import BatchLoader
from dmel_tpu_torch.device import resolve_device
from dmel_tpu_torch.experiments.configs import get_search_space
from dmel_tpu_torch.experiments.runner import run_sweep_packed
from dmel_tpu_torch.models.classifiers import MelPANNsNet
from dmel_tpu_torch.models.registry import (dispatch_hint_for,
                                            get_model_by_config,
                                            n_classes_for)
from dmel_tpu_torch.ops.spectrogram import (bucketed_window_length,
                                            optimized_window_length)
from dmel_tpu_torch.parallel.mesh import (all_reduce_sum,
                                          initialize_distributed, make_mesh,
                                          place_global_batch, replicate)
from dmel_tpu_torch.parallel.trials import fit_trials
from dmel_tpu_torch.precision import precision_scope
from dmel_tpu_torch.training.optim import build_optimizer
from dmel_tpu_torch.training.train import fit, train_step

_REPO = str(Path(__file__).resolve().parents[2])

#: the tiny DMEL probe of the dry run (the JAX package's)
DRYRUN_CONFIG = dict(model_name="mel_linear_net", dataset_name="audio_mnist",
                     init_lambd=46.67, n_points=256, hop_length=16,
                     optimized=False, normalize_window=False, n_mels=16,
                     resample_rate=8000, energy_normalize=True,
                     optimizer_name="adam", lr_model=1e-4, lr_tf=1.0,
                     trainable=True)


def entry(device=None):
    """``(forward, (x,))``: MelPANNsNet at lambda 46.67 (8000 * 0.035 / 6,
    the optimized window of 512), 50 classes, 4 clips of 4000 samples,
    on ``device`` (default ``cuda``); ``forward(x)`` gives the eval-mode
    logits, (4, 50)."""
    dev = resolve_device(device)
    init_lambd = 46.67
    model = MelPANNsNet(
        n_classes=50, init_lambd=init_lambd, n_mels=64, n_points=4000,
        sample_rate=8000, hop_length=80, optimized=True,
        window_length=optimized_window_length(init_lambd),
        energy_normalize=True,
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.zeros((4, 4000), device=dev)

    def forward(x):
        with torch.no_grad(), precision_scope():
            return model(x)[0]

    return forward, (x,)


def toy_dataset(n: int, n_points: int, seed: int = 0,
                n_classes: int = 10) -> ArrayDataset:
    """``n`` clips of white noise and uniform labels from
    ``default_rng(seed)``, at 8 kHz."""
    rng = np.random.default_rng(seed)
    return ArrayDataset(rng.standard_normal((n, n_points)).astype(np.float32),
                        rng.integers(0, n_classes, n).astype(np.int32), 8000)


def dryrun_multichip(n_devices: int, mesh=None,
                     checkpoint_dir: Optional[str] = None) -> dict:
    """The dry run on this rank of ``mesh`` (default :func:`make_mesh`),
    which must have ``n_devices`` ranks: one data-parallel train step of
    :data:`DRYRUN_CONFIG` on a global batch of ``2 n_devices`` clips,
    ``fit_trials`` of ``n_devices`` trials (one a rank) and a 3-epoch
    ``fit`` in optimized mode with ``lr_tf`` 50, so that lambda crosses
    buckets, keeping its best model under ``checkpoint_dir``.  Returns
    the step's loss, the gradient's norm, the all-reduced count of ranks
    and the trials' and the fit's records: the same on every rank."""
    mesh = make_mesh() if mesh is None else mesh
    if mesh.size != n_devices:
        raise ValueError(f"the mesh has {mesh.size} ranks, not {n_devices}")
    dev = mesh.device
    cfg = DRYRUN_CONFIG
    model = get_model_by_config(cfg, device=dev, seed=0)
    optimizer = build_optimizer(cfg, model)
    replicate(model, mesh)

    batch = 2 * n_devices
    x = np.random.default_rng(0).standard_normal((batch, 256)).astype(
        np.float32)
    y = np.arange(batch, dtype=np.int32) % 10
    xs, ys, mask = place_global_batch((x, y, np.ones(batch, bool)), mesh)
    generator = torch.Generator(device=dev).manual_seed(1)
    with precision_scope():
        metrics = train_step(model, optimizer, xs, ys, mask, one_hot=False,
                             n_classes=10, mesh=mesh, generator=generator)
    grad_norm = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                     for p in model.parameters()
                                     if p.grad is not None)))
    ranks = float(all_reduce_sum(torch.ones((), device=dev), mesh))
    if not np.isfinite(float(metrics["loss"])):
        raise RuntimeError(f"non-finite loss {float(metrics['loss'])}")

    tiny = toy_dataset(8, 256, seed=1)
    configs = [dict(cfg, init_lambd=10.0 + 5 * i, batch_size=2,
                    max_epochs=1, patience=10, trainable=bool(i % 2))
               for i in range(n_devices)]
    _, hists = fit_trials(configs, tiny, tiny, mesh=mesh)

    fit_cfg = dict(cfg, optimized=True, batch_size=batch, max_epochs=3,
                   patience=1, init_lambd=20.0, lr_tf=50.0)
    rng = np.random.default_rng(2)
    tr = ArrayDataset(rng.standard_normal((4 * batch, 256)).astype(np.float32),
                      (np.arange(4 * batch) % 10).astype(np.int32), 8000)
    va = ArrayDataset(rng.standard_normal((2 * batch, 256)).astype(np.float32),
                      (np.arange(2 * batch) % 10).astype(np.int32), 8000)
    _, hist = fit(fit_cfg, tr, va, seed=0, mesh=mesh,
                  checkpoint_dir=checkpoint_dir)
    if not all(np.isfinite(r["loss"]) for r in hist["records"]):
        raise RuntimeError(f"non-finite fit loss {hist['records']}")
    return dict(loss=float(metrics["loss"]), grad_norm=grad_norm,
                ranks=ranks, trials=[h["records"] for h in hists],
                fit=hist["records"], est_lambd=hist["est_lambd"])


# --- the jobs a rank runs -------------------------------------------------

def _digest(tensors: dict) -> str:
    """sha256 of the tensors' bits, in the dict's order."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def job_datasets(spec: dict):
    """``(trainset, validset)`` of a job: ``spec["toy"]`` (``n_train``,
    ``n_valid``, ``n_points``, ``seed``, ``n_classes``) or the splits of
    ``spec["config"]`` (:func:`get_dataset_by_config`)."""
    toy = spec.get("toy")
    if toy is None:
        return get_dataset_by_config(spec["config"], spec.get("data_dir"))[:2]
    n_classes = toy.get("n_classes", 10)
    return (toy_dataset(toy["n_train"], toy["n_points"], toy["seed"],
                        n_classes),
            toy_dataset(toy["n_valid"], toy["n_points"], toy["seed"] + 1,
                        n_classes))


class _Counters:
    """Launch counters named ``{name: [module, qualname, attribute]}``
    (each kernel wrapper's count): zeroed, then read."""

    def __init__(self, spec: Optional[dict]):
        self.refs = {}
        for name, (module, qualname, attr) in (spec or {}).items():
            obj = importlib.import_module(module)
            for part in qualname.split("."):
                obj = getattr(obj, part)
            self.refs[name] = (obj, attr)

    def zero(self):
        for obj, attr in self.refs.values():
            setattr(obj, attr, 0)

    def read(self) -> dict:
        return {name: getattr(obj, attr)
                for name, (obj, attr) in self.refs.items()}


def _save(out: Optional[str], mesh, name: str, payload: dict) -> None:
    if out is not None and mesh.rank == 0:
        torch.save(payload, os.path.join(out, f"{name}.pt"))


def fit_job(spec: dict, mesh, out: Optional[str]) -> dict:
    """``fit(config, ..., seed, mesh)`` on the job's datasets (``config``,
    ``seed``, ``toy`` or ``data_dir``, ``counters``): the records, lambda,
    the state's digest and each epoch's counts at its report; rank 0
    saves the state dict to ``<out>/<name>.pt``."""
    trainset, validset = job_datasets(spec)
    counters = _Counters(spec.get("counters"))
    seen = []
    counters.zero()
    t0 = time.perf_counter()
    state, history = fit(spec["config"], trainset, validset,
                         seed=spec.get("seed", 0), mesh=mesh,
                         report_fn=lambda r: seen.append(counters.read()))
    fit_s = time.perf_counter() - t0
    sd = state["model"].state_dict()
    _save(out, mesh, spec["name"], {"model": sd,
                                    "records": history["records"]})
    return dict(records=history["records"], est_lambd=history["est_lambd"],
                init_lambd=history["init_lambd"], digest=_digest(sd),
                launches=seen, fit_s=fit_s)


def run_steps(spec: dict, mesh) -> tuple[dict, dict]:
    """``n_steps`` train steps of ``config`` on a mesh, from the weights
    of ``seed`` or of the state dict saved at ``init``, over the first
    batches of the train loader ``fit`` builds (``batch_size`` rows,
    shuffled with ``seed``; ``toy`` or ``data_dir``), at the bucket and
    hint of the initial lambda, the dropout generator seeded with
    ``seed``: ``fit``'s first steps (with ``float64``, the model and the
    clips in float64).  Returns the steps' metrics and times (host
    clock, synchronised) and, after step ``snapshot`` (default the
    last), the ``state`` dict and the ``grads`` on the CPU."""
    config, seed = spec["config"], spec.get("seed", 0)
    n_steps = int(spec["n_steps"])
    snapshot = int(spec.get("snapshot", n_steps))
    trainset, _ = job_datasets(spec)
    dev = mesh.device
    lam = float(config["init_lambd"])
    wl = (bucketed_window_length(lam, int(config["n_points"]))
          if config.get("optimized", False) else None)
    model = get_model_by_config(config, window_length=wl,
                                lambd_hint=dispatch_hint_for(config, wl, lam),
                                device=dev, seed=seed)
    if spec.get("init"):
        model.load_state_dict(torch.load(spec["init"], weights_only=True))
    dtype = torch.float64 if spec.get("float64") else torch.float32
    model.to(dtype)
    optimizer = build_optimizer(config, model)
    replicate(model, mesh)
    generator = torch.Generator(device=dev).manual_seed(seed)
    loader = BatchLoader(trainset, int(config["batch_size"]), shuffle=True,
                         seed=seed)
    kw = dict(one_hot="panns" in config["model_name"],
              n_classes=n_classes_for(config["dataset_name"]))
    metrics, step_ms, saved = [], [], None
    with precision_scope():
        for i, batch in zip(range(n_steps), loader):
            xs, ys, mask = place_global_batch(batch, mesh)
            xs = xs.to(dtype)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            m = train_step(model, optimizer, xs, ys, mask,
                           generator=generator, mesh=mesh, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if i + 1 == snapshot:
                saved = dict(
                    state={k: v.detach().cpu().clone()
                           for k, v in model.state_dict().items()},
                    grads={k: p.grad.detach().cpu().clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None})
    if saved is None:
        raise ValueError(f"the loader gave fewer than {snapshot} batches")
    return dict(metrics=metrics, step_ms=step_ms), saved


def steps_job(spec: dict, mesh, out: Optional[str]) -> dict:
    """:func:`run_steps`: its metrics and times, and the digest of the
    snapshot, which rank 0 saves to ``<out>/<name>.pt``."""
    res, saved = run_steps(spec, mesh)
    _save(out, mesh, spec["name"], dict(saved, metrics=res["metrics"]))
    return dict(res, digest=_digest({**saved["state"], **saved["grads"]}))


def trials_job(spec: dict, mesh, out: Optional[str]) -> dict:
    """``fit_trials(configs, ..., seed, mesh)`` on the job's datasets: every
    trial's records, and the digest of this rank's pack; every rank saves
    its trials' final state dicts, by trial index, to
    ``<out>/<name>.rank<r>.pt``."""
    trainset, validset = job_datasets(spec)
    state, hists = fit_trials(spec["configs"], trainset, validset,
                              seed=spec.get("seed", 0), mesh=mesh)
    if out is not None:
        torch.save({i: state["pack"].trial_state_dict(j)
                    for j, i in enumerate(state["trials"])},
                   os.path.join(out, f"{spec['name']}.rank{mesh.rank}.pt"))
    return dict(records=[h["records"] for h in hists],
                trials=state["trials"], digest=_digest(state["pack"].state()))


def sweep_job(spec: dict, mesh, out: Optional[str]) -> dict:
    """``run_sweep_packed`` of the space ``space_name`` (``max_epochs``,
    ``output_dir``, ``data_dir``; ``override``: keys set on the whole
    space) over the mesh: the sweep directory and this rank's counts
    (``counters``) over the run."""
    epochs = int(spec["max_epochs"])
    space = dict(get_search_space(spec["space_name"], epochs),
                 **spec.get("override", {}))
    counters = _Counters(spec.get("counters"))
    counters.zero()
    t0 = time.perf_counter()
    sweep_dir = run_sweep_packed(spec["space_name"], 1, epochs,
                                 spec["output_dir"], spec["data_dir"],
                                 space=space, mesh=mesh)
    return dict(sweep_dir=sweep_dir, launches=counters.read(),
                sweep_s=time.perf_counter() - t0)


def dryrun_job(spec: dict, mesh, out: Optional[str]) -> dict:
    """:func:`dryrun_multichip` over the whole mesh, its checkpoints under
    ``<out>/rank<r>`` where ``out`` is given."""
    ckpt = (os.path.join(out, f"rank{mesh.rank}") if out is not None
            else None)
    return dryrun_multichip(mesh.size, mesh, ckpt)


#: the jobs a rank runs, by name
JOBS = {"dryrun": dryrun_job, "fit": fit_job, "steps": steps_job,
        "trials": trials_job, "sweep": sweep_job}


def run_job(spec: dict, mesh, out: Optional[str] = None) -> dict:
    """One job of :data:`JOBS` on this rank."""
    return JOBS[spec["job"]](spec, mesh, out)


def _rank_main(args) -> None:
    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{args.port}", args.nproc, args.rank,
                           backend=args.backend or (
                               "gloo" if args.device == "cpu" else "nccl"))
    try:
        mesh = make_mesh(devices="cpu" if args.device == "cpu" else None)
        jobs = _jobs(args.jobs)
        for spec in jobs:
            res = run_job(spec, mesh, args.out)
            print("RESULT", spec.get("name", spec["job"]), json.dumps(res),
                  flush=True)
    finally:
        dist.destroy_process_group()


def _jobs(path: Optional[str]) -> list:
    if path is None:
        return [{"job": "dryrun"}]
    with open(path) as f:
        return json.load(f)


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFailure(RuntimeError):
    """A rank exited with an error, or the ranks ran out of time."""


def launch(nproc: int, device: str = "cuda", backend: Optional[str] = None,
           jobs: Optional[list] = None, out: Optional[str] = None,
           timeout: float = 600.0) -> list:
    """Run ``jobs`` (default: the dry run) on ``nproc`` ranks of this
    machine and return each rank's results, ``[{name: result}, ...]`` in
    rank order.  Raises :class:`RankFailure`, with the end of every
    rank's output, when a rank fails or ``timeout`` seconds pass; every
    rank is killed first."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "dmel_tpu_torch.parallel.dryrun",
                "--nproc", str(nproc), "--device", device,
                "--port", str(free_port())]
        if backend is not None:
            argv += ["--backend", backend]
        if jobs is not None:
            path = os.path.join(tmp, "jobs.json")
            with open(path, "w") as f:
                json.dump(jobs, f)
            argv += ["--jobs", path]
        if out is not None:
            argv += ["--out", out]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(nproc)]
        procs = []
        failure = None
        try:
            for r, log in enumerate(logs):
                procs.append(subprocess.Popen(
                    argv + ["--rank", str(r)], stdout=log,
                    stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while failure is None:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failure = (f"rank {bad[0]} exited with "
                               f"{codes[bad[0]]}")
                elif time.monotonic() > deadline:
                    failure = f"the ranks ran out of {timeout} s"
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    if failure is not None:
        tails = "\n".join(f"--- rank {r} ---\n{t[-3000:]}"
                          for r, t in enumerate(texts))
        raise RankFailure(f"{failure}\n{tails}")
    results = []
    for text in texts:
        mine = {}
        for line in text.splitlines():
            if line.startswith("RESULT "):
                _, name, payload = line.split(" ", 2)
                mine[name] = json.loads(payload)
        results.append(mine)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--jobs", default=None,
                    help="a JSON file of jobs (default: the dry run)")
    ap.add_argument("--out", default=None,
                    help="a directory for the jobs' files")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    jobs = _jobs(args.jobs) if args.jobs is not None else None
    try:
        results = launch(args.nproc, args.device, args.backend, jobs,
                         args.out, args.timeout)
    except RankFailure as e:
        print(e, file=sys.stderr, flush=True)
        return 1
    for r, mine in enumerate(results):
        for name, res in mine.items():
            print(f"rank {r} {name} {json.dumps(res)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
