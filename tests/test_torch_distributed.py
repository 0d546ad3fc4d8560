"""The port's data parallelism (``dmel_tpu_torch.parallel.mesh``) on the
CPU, in four gloo ranks started once by ``dmel_tpu_torch.parallel
.dryrun``'s launcher from its command line, for every check below; the
single-process references are computed while the ranks run.  Rank 0
saves the tensors; every rank prints its results and the digest of its
state.

- ``fit(mesh=...)`` against the port's single-process ``fit`` (1 epoch)
  on ``mel_linear_net`` (dropout; dmel_tpu's ``tests/test_parallel.py``
  config) and ``bn_linear_net`` (batch norm, at the same size): loss
  within 1e-4 relative, parameters and buffers within 1e-4 max-abs
  (dmel_tpu's gate), the ranks bit-identical;
- a padded tail batch (8 rows, 5 kept: ranks 2 and 3 hold padding only):
  every gradient within 1e-5 of its largest entry of one process's;
- one data-parallel step of MelPANNsNet at ``test_torch_training.py``'s
  CONFIG (4000 samples, lambda 128, the specband route's plain
  versions), batch 8, against the port's single-process step (which
  ``test_train_step_matches_jax`` holds to dmel_tpu), dropout on with
  the same generator: loss 1e-5 relative, dlambda 1e-4 relative, every
  other gradient 1e-4 in norm (entries on ReLU boundaries move), running
  means 1e-5 and variances 1e-5 of their largest entry; also with
  SpecAugment on, its masks drawn at the global batch;
- one data-parallel step of ``bn_linear_net`` from dmel_tpu's weights
  against dmel_tpu's ``make_train_step`` on a 4-device mesh of the
  conftest's virtual CPU devices: ``test_train_step_matches_jax``'s
  gates (loss 1e-5, gradients 1e-2 in norm, statistics 1e-5), the
  global batch statistics being dmel_tpu's;
- ``fit_trials`` with 8 trials over the 4 ranks (2 a rank) against the
  unsharded pack (every trial's loss within 1e-4 relative);
- ``fit_trials`` of 4 MelPANNsNet trials with SpecAugment over the 4
  ranks (one a rank, two steps) against the unsharded pack: every
  trial's losses within 1e-4 relative and its state within 1e-4, the
  pack-wide dropout and SpecAugment masks split by trial;
- the dry run: the ranks' result lines identical, rank 0 alone writing
  its best model.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmel_tpu import parallel as jparallel
from dmel_tpu.models import registry as jregistry
from dmel_tpu.training import train as jtrain
from dmel_tpu_torch import fit, from_jax_variables
from dmel_tpu_torch.data.loader import BatchLoader
from dmel_tpu_torch.parallel import dryrun, mesh as tmesh
from dmel_tpu_torch.parallel import trials as ttrials
from tests.test_torch_parallel import small_cfg
from tests.test_torch_training import CONFIG as CNN6_CONFIG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
#: seconds the launcher gives its ranks; the parent waits a little more
TIMEOUT_S = 120

MEL = small_cfg(max_epochs=1)
BN = dict(small_cfg(max_epochs=1), model_name="bn_linear_net",
          dataset_name="time_frequency", n_points=64, hop_length=1)
CNN6 = dict(CNN6_CONFIG, batch_size=8)
TRIALS = [small_cfg(init_lambd=5.0 + i, max_epochs=1) for i in range(8)]
CNN6_TRIALS = [dict(CNN6, init_lambd=lam, max_epochs=1, augment=True)
               for lam in (128.0, 120.0, 124.0, 126.0)]


def _toy(n_train, n_points, n_classes=10, n_valid=16, seed=0):
    return {"n_train": n_train, "n_valid": n_valid, "n_points": n_points,
            "seed": seed, "n_classes": n_classes}


FIT_JOBS = {
    "fit_mel": {"job": "fit", "config": MEL, "toy": _toy(64, 256)},
    "fit_bn": {"job": "fit", "config": BN, "toy": _toy(48, 64, 3)},
}
STEP_JOBS = {
    "tail_mel": {"job": "steps", "n_steps": 1, "toy": _toy(5, 256),
                 "config": dict(MEL, batch_size=8)},
    "tail_bn": {"job": "steps", "n_steps": 1, "toy": _toy(5, 64, 3),
                "config": dict(BN, batch_size=8)},
    "cnn6": {"job": "steps", "n_steps": 1, "toy": _toy(8, 4000),
             "config": CNN6},
    "cnn6_f64": {"job": "steps", "n_steps": 1, "toy": _toy(8, 4000),
                 "config": dict(CNN6, impl="xla"), "float64": True},
    "cnn6_aug_f64": {"job": "steps", "n_steps": 1, "toy": _toy(8, 4000),
                     "config": dict(CNN6, impl="xla", augment=True),
                     "float64": True},
}
TRIAL_JOBS = {
    "trials": {"job": "trials", "configs": TRIALS, "toy": _toy(32, 256)},
    "cnn6_pack": {"job": "trials", "configs": CNN6_TRIALS,
                  "toy": _toy(16, 4000, 50, n_valid=8)},
}


def _grad_capture():
    """An optax transformation whose state after a step is the step's
    gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_bn_init(init_path):
    """dmel_tpu's ``bn_linear_net`` and its init, saved to ``init_path``
    under the port's names; the spec of the port's job from it."""
    config = dict(BN, batch_size=8)
    spec = {"job": "steps", "name": "jax_bn", "n_steps": 1,
            "toy": _toy(8, 64, 3), "config": config, "init": init_path}
    jmodel = jregistry.get_model_by_config(config)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                           jnp.zeros((8, 64))))
    torch.save(from_jax_variables(variables["params"],
                                  variables["batch_stats"]), init_path)
    return spec, jmodel, variables


def _jax_bn_step(spec, jmodel, variables):
    """dmel_tpu's train step of ``jmodel`` on a 4-device data mesh from
    ``variables``, on the first batch of the port's loader: its loss,
    gradients and statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    toy = spec["toy"]
    trainset = dryrun.toy_dataset(8, 64, toy["seed"], 3)
    xs, ys, mask = next(iter(BatchLoader(trainset, 8, shuffle=True, seed=0)))
    mesh = jparallel.make_mesh(("data",), devices=jax.devices()[:RANKS])
    sharding = jparallel.batch_sharding(mesh)
    put = lambda a: jax.device_put(a, sharding)  # noqa: E731
    capture = _grad_capture()
    step = jtrain.make_train_step(jmodel, capture, False, 3)
    _, grads, new_stats, _, metrics = step(
        jparallel.replicate(params, mesh), capture.init(params),
        jparallel.replicate(stats, mesh), jax.random.PRNGKey(1),
        put(xs), put(ys), put(mask))
    return dict(loss=float(metrics["loss"]),
                grads=from_jax_variables(jax.device_get(grads)),
                stats=from_jax_variables({}, jax.device_get(new_stats)))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The four ranks' results (the launcher's command line, one run) and
    the single-process references, computed while the ranks run."""
    out = tmp_path_factory.mktemp("ranks")
    jax_spec, jmodel, variables = _jax_bn_init(str(out / "jax_bn_init.pt"))
    jobs = [{"job": "dryrun", "name": "dryrun"}]
    jobs += [dict(spec, name=name) for name, spec in
             {**FIT_JOBS, **STEP_JOBS}.items()]
    jobs += [jax_spec]
    jobs += [dict(spec, name=name) for name, spec in TRIAL_JOBS.items()]
    path = out / "jobs.json"
    path.write_text(json.dumps(jobs))
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmel_tpu_torch.parallel.dryrun", "--nproc",
         str(RANKS), "--device", "cpu", "--jobs", str(path), "--out",
         str(out), "--timeout", str(TIMEOUT_S)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        single = {"jax_bn": _jax_bn_step(jax_spec, jmodel, variables)}
        for name, spec in TRIAL_JOBS.items():
            tr, va = dryrun.job_datasets(spec)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)        # a rank's arithmetic
            try:
                state, hists = ttrials.fit_trials(spec["configs"], tr, va,
                                                  device="cpu")
            finally:
                torch.set_num_threads(threads)
            single[name] = (state["pack"], hists)
        for name, spec in FIT_JOBS.items():
            tr, va = dryrun.job_datasets(spec)
            state, hist = fit(spec["config"], tr, va, seed=0, device="cpu")
            single[name] = (state["model"].state_dict(), hist["records"])
        one = tmesh.make_mesh(devices="cpu")     # one rank, no collective
        for name, spec in STEP_JOBS.items():
            single[name] = dryrun.run_steps(spec, one)
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S + 30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    ranks = [{} for _ in range(RANKS)]
    for line in stdout.splitlines():
        if line.startswith("rank "):
            _, r, name, payload = line.split(" ", 3)
            ranks[int(r)][name] = json.loads(payload)
    return dict(out=out, ranks=ranks, single=single)


def _load(four, name):
    return torch.load(four["out"] / f"{name}.pt", weights_only=True)


def _same_on_every_rank(four, name, own=()):
    """The ranks' results of job ``name``, which must agree (their times,
    and the keys ``own`` of each rank's own share, aside)."""
    results = [{k: v for k, v in r[name].items()
                if k not in ("fit_s", "step_ms", *own)}
               for r in four["ranks"]]
    assert all(r == results[0] for r in results[1:]), name
    return results[0]


def _norm_err(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("name", sorted(FIT_JOBS))
def test_dp_fit_matches_one_process(four, name):
    got = _same_on_every_rank(four, name)
    sd, records = four["single"][name]
    saved = _load(four, name)
    assert saved["records"] == got["records"]
    for mine, want in zip(got["records"], records):
        for key in ("loss", "valid_loss", "lambd_est"):
            assert abs(mine[key] - want[key]) <= 1e-4 * max(1.0,
                                                            abs(want[key]))
    assert sorted(saved["model"]) == sorted(sd)
    for key, want in sd.items():
        err = float((saved["model"][key].double() - want.double()).abs().max())
        assert err <= 1e-4, (key, err)
    assert got["records"][-1]["lambd_est"] != MEL["init_lambd"]


@pytest.mark.parametrize("name", ["tail_mel", "tail_bn"])
def test_dp_tail_batch_gradient(four, name):
    """Ranks 2 and 3 hold padded rows only; the global count of kept rows
    normalises every rank's share."""
    _same_on_every_rank(four, name)
    saved = _load(four, name)
    res, want = four["single"][name]
    assert res["metrics"][0]["loss"] == pytest.approx(
        saved["metrics"][0]["loss"], rel=1e-5)
    assert sorted(saved["grads"]) == sorted(want["grads"])
    for key, w in want["grads"].items():
        err = float((saved["grads"][key] - w).abs().max() / w.abs().max())
        assert err <= 1e-5, (key, err)


@pytest.mark.parametrize("name,grad_gate", [("cnn6", 1e-2),
                                            ("cnn6_f64", 1e-4),
                                            ("cnn6_aug_f64", 1e-4)])
def test_dp_cnn6_step_matches_one_process(four, name, grad_gate):
    """In float32 on the specband route (``cnn6``) the gradients are held
    to ``test_train_step_matches_jax``'s 1e-2: the gradients of lambda,
    of the mel batch norm and of the first block come from sums that
    nearly cancel in the first block's batch-norm backward, and the one
    process's own float32 step moves them by up to 1.5e-3 in norm
    between 1 and 8 CPU threads (dlambda by 1e-3; 6e-3 with dropout
    off).  In float64 on the exact route (``cnn6_f64``, the same weights,
    clips and masks) that noise is gone, and every gradient and dlambda
    is held to 1e-4; ``cnn6_aug_f64`` adds SpecAugment, whose masks each
    rank takes from the global batch's draw."""
    _same_on_every_rank(four, name)
    saved = _load(four, name)
    res, want = four["single"][name]
    loss, want_loss = saved["metrics"][0]["loss"], res["metrics"][0]["loss"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    lam = "spectrogram_layer.lambd"
    assert sorted(saved["grads"]) == sorted(want["grads"])
    assert abs(float(saved["grads"][lam] / want["grads"][lam]) - 1) <= (
        grad_gate)
    for key, w in want["grads"].items():
        if key != lam:
            assert _norm_err(saved["grads"][key], w) <= grad_gate, key
    n_stats = 0
    for key, w in want["state"].items():
        got = saved["state"][key]
        if key.endswith("running_mean"):
            assert float((got - w).abs().max()) <= 1e-5, key
        elif key.endswith("running_var"):
            assert float((got - w).abs().max() / w.abs().max()) <= 1e-5, key
        else:
            continue
        n_stats += 1
    assert n_stats == 10      # bn1 over the mel bins and four 2-D norms


def test_dp_bn_step_matches_jax_mesh(four):
    _same_on_every_rank(four, "jax_bn")
    saved, want = _load(four, "jax_bn"), four["single"]["jax_bn"]
    assert abs(saved["metrics"][0]["loss"] - want["loss"]) <= 1e-5 * abs(
        want["loss"])
    assert sorted(saved["grads"]) == sorted(want["grads"])
    for key, w in want["grads"].items():
        assert _norm_err(saved["grads"][key], w) <= 1e-2, key
    stats = {k: v for k, v in want["stats"].items() if "running" in k}
    assert sorted(stats) == ["bn.running_mean", "bn.running_var"]
    assert float((saved["state"]["bn.running_mean"]
                  - stats["bn.running_mean"]).abs().max()) <= 1e-5
    var = stats["bn.running_var"]
    assert float((saved["state"]["bn.running_var"] - var).abs().max()
                 / var.abs().max()) <= 1e-5


def test_dryrun_ranks_agree(four):
    """The dry run's result lines are identical on the four ranks (the
    all-reduce counted four), and rank 0 alone wrote a best model."""
    got = _same_on_every_rank(four, "dryrun")
    assert got["ranks"] == float(RANKS)
    assert len(got["trials"]) == RANKS and len(got["fit"]) >= 1
    assert (four["out"] / "rank0" / "best_model").exists()
    for r in range(1, RANKS):
        assert not (four["out"] / f"rank{r}").exists()


@pytest.mark.parametrize("name", sorted(TRIAL_JOBS))
def test_sharded_fit_trials_matches_unsharded(four, name):
    """The trials split over 4 ranks (``trials``: 8 mel probes, 2 a rank;
    ``cnn6_pack``: 4 MelPANNsNet with SpecAugment, one a rank) against
    the whole pack in one process: every trial's epoch losses within
    1e-4 relative (the pack-wide dropout and SpecAugment masks drawn
    alike), and every tensor of its final state within 1e-4.  The whole
    pack runs on one thread, as a rank does: CNN6's float32 epoch moves
    by up to 6e-4 relative in its valid loss, and its state by 7e-3,
    between 1 and 8 threads of one process."""
    got = _same_on_every_rank(four, name, own=("trials", "digest"))
    k = len(TRIAL_JOBS[name]["configs"])
    share = k // RANKS
    assert [r[name]["trials"] for r in four["ranks"]] == [
        list(range(r * share, (r + 1) * share)) for r in range(RANKS)]
    pack, hists = four["single"][name]
    for mine, w in zip(got["records"], hists):
        assert len(mine) == len(w["records"])
        for key in ("loss", "valid_loss", "lambd_est"):
            assert mine[0][key] == pytest.approx(w["records"][0][key],
                                                 rel=1e-4)
    saved = {}
    for r in range(RANKS):
        saved.update(torch.load(four["out"] / f"{name}.rank{r}.pt",
                                weights_only=True))
    assert sorted(saved) == list(range(k))
    for i, sd in saved.items():
        want = pack.trial_state_dict(i)
        assert sorted(sd) == sorted(want)
        for key, w in want.items():
            err = float((sd[key].double() - w.double()).abs().max())
            assert err <= 1e-4, (i, key, err)


def test_entry_forward():
    fn, args = dryrun.entry(device="cpu")
    assert fn(*args).shape == (4, 50)
