"""The port's modules and public names against dmel_tpu's, on the CPU.

For each subpackage of ``dmel_tpu`` (the top level included):

- (a) every public name its ``__init__`` exports is an attribute of the
  port's package of the same path;
- (b) every module file has a file of the same path under
  ``dmel_tpu_torch/``;
- (c) every public function, class and constant of a module file is an
  attribute of the port's module of the same path;
- (d) every exception to (a)-(c) is an entry of :data:`DIFFERENCES`, the
  one table of deliberate differences, with its reason; no entry names
  something the port has since gained, and none is stale (names what
  ``dmel_tpu`` no longer has).

Names are read from ``dmel_tpu``'s sources by ``ast``; the port's are
its modules' attributes.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "dmel_tpu", "dmel_tpu_torch"

TPU_NUMERICS = ("a workaround for the TPU's approximate log; torch's log "
                "on the CPU and the H100 needs none")
XLA_STFT = ("an XLA formulation of the STFT for the TPU's MXU (bf16 "
            "passes, GEMM-shaped DFTs); the port's exact route is "
            "torch.stft (cuFFT on the card) and its kernels are CUDA C++")
JIT_FACTORY = ("a factory of jax.jit-compiled steps; the port calls its "
               "plain train_step and eval_step")

#: Every deliberate difference between the two packages: ``(path, what)``
#: -> reason.  ``path`` is a module file under ``dmel_tpu/``; ``what`` is
#: None for the whole file, a public name the port's module lacks, or,
#: for a behaviour, a description checked in :data:`BEHAVIOURS`.
DIFFERENCES = {
    ("ops/numerics.py", None): TPU_NUMERICS,
    ("ops/__init__.py", "accurate_log"): TPU_NUMERICS,
    ("ops/pallas/__init__.py", None):
        "the package of the Pallas TPU kernels; the port's kernels are "
        "CUDA C++ sources under dmel_tpu_torch/csrc/, built by "
        "ops/_cuda.py",
    ("ops/pallas/specband_dmel.py", None):
        "K1 and K2: csrc/specband_fwd.cu and csrc/specband_bwd.cu, behind "
        "ops/specband.py",
    ("ops/pallas/framed_dmel.py", None):
        "K3 and K4: csrc/framed_fwd.cu and csrc/framed_bwd.cu, behind "
        "ops/framed.py",
    ("ops/pallas/fused_dmel.py", None):
        "K5 and K6: second entry points of csrc/framed_fwd.cu and "
        "csrc/framed_bwd.cu, behind ops/fused.py",
    ("ops/__init__.py", "stft_power_folded"): XLA_STFT,
    ("ops/__init__.py", "stft_power_conv"): XLA_STFT,
    ("ops/__init__.py", "stft_power_specgemm"): XLA_STFT,
    ("ops/__init__.py", "stft_power_matmul_ext_mp"): XLA_STFT,
    ("ops/__init__.py", "specgemm_ok"): XLA_STFT,
    ("ops/__init__.py", "dft_matrices"): XLA_STFT,
    ("ops/stft.py", "stft_power_folded"): XLA_STFT,
    ("ops/stft.py", "stft_power_conv"): XLA_STFT,
    ("ops/stft.py", "stft_power_specgemm"): XLA_STFT,
    ("ops/stft.py", "stft_power_matmul_ext_mp"): XLA_STFT,
    ("ops/stft.py", "specgemm_ok"): XLA_STFT,
    ("ops/stft.py", "dft_matrices"): XLA_STFT,
    ("ops/stft.py", "DEVICE_BASIS_MIN_N_FFT"):
        "the n_fft from which the XLA DFT basis is generated on the TPU",
    ("ops/stft.py", "frame_signal_ext"):
        "gather-free framing for the TPU's fused kernel; the CUDA kernels "
        "read their frames from the signal",
    ("ops/stft.py", "sliding_group"):
        "the lane-aligned frame group of the TPU's sliding DFT",
    ("ops/stft.py", "pad_window"):
        "in the port it lives in ops/fused.py, beside the one route that "
        "pads a window, and is exported as ops.pad_window",
    ("models/common.py", None):
        "flax initialisers that copy torch's defaults; the port's layers "
        "are torch's, with their own defaults and nn.init",
    ("models/panns.py", "Patches5x5Conv"):
        "an im2col rewrite of a one-channel 5x5 convolution for the "
        "TPU's MXU; the port's Cnn6 calls cuDNN's convolution",
    ("training/__init__.py", "make_train_step"): JIT_FACTORY,
    ("training/__init__.py", "make_eval_step"): JIT_FACTORY,
    ("training/train.py", "make_train_step"): JIT_FACTORY,
    ("training/train.py", "make_eval_step"): JIT_FACTORY,
    ("training/__init__.py", "param_labels"):
        "an optax label tree; the port's optimizer takes torch parameter "
        "groups (build_optimizer)",
    ("training/optim.py", "param_labels"):
        "an optax label tree; the port's optimizer takes torch parameter "
        "groups (build_optimizer)",
    ("eval/figures.py", "seaborn's bootstrapped 95 % band"):
        "random in dmel_tpu (n_boot with no seed) and of zero width at the "
        "published grids (one trial per lambda_init and trainable); the "
        "port draws the lines, markers, legends and limits without it, "
        "and needs neither pandas nor seaborn",
}


def _source(pkg, path):
    with open(os.path.join(ROOT, pkg, path)) as f:
        return f.read()


def _band_difference():
    """(dmel_tpu still draws seaborn's band, the port still does not)."""
    jax_src = _source(JAX_PKG, "eval/figures.py")
    port_src = _source(PORT_PKG, "eval/figures.py")
    return ("sns.lineplot(" in jax_src and "errorbar" not in jax_src,
            "fill_between" not in port_src and "seaborn" not in
            _imported_modules(port_src))


#: how each behaviour entry of DIFFERENCES is checked
BEHAVIOURS = {
    ("eval/figures.py", "seaborn's bootstrapped 95 % band"):
        _band_difference,
}


def _imported_modules(src):
    """The top-level package of every import in ``src``."""
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    return mods


def _module_files():
    """Every module file of dmel_tpu, as a path relative to the package."""
    out = []
    base = os.path.join(ROOT, JAX_PKG)
    for root, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        out += [os.path.relpath(os.path.join(root, f), base)
                for f in sorted(files) if f.endswith(".py")]
    return out


MODULE_FILES = _module_files()
SUBPACKAGES = sorted({os.path.dirname(p) for p in MODULE_FILES})


def _subpackage(path):
    return os.path.dirname(path)


def _public_names(path):
    """The public names ``dmel_tpu/<path>`` defines at its top level
    (and, for an ``__init__``, the names it imports)."""
    tree = ast.parse(_source(JAX_PKG, path))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif (isinstance(node, ast.ImportFrom)
              and path.endswith("__init__.py")):
            names += [a.asname or a.name for a in node.names]
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def _port_module(path):
    mod = path[:-len(".py")].replace(os.sep, ".")
    mod = mod[:-len("__init__")].rstrip(".") if mod.endswith(
        "__init__") else mod
    return importlib.import_module(".".join(filter(None, [PORT_PKG, mod])))


def _port_has_file(path):
    return os.path.isfile(os.path.join(ROOT, PORT_PKG, path))


def _missing_names(path):
    """Public names of ``dmel_tpu/<path>`` the port's module lacks."""
    port = _port_module(path)
    return [n for n in _public_names(path) if not hasattr(port, n)]


def _in_table(path, what):
    return (path, what) in DIFFERENCES


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_init_names(sub):
    """(a) the subpackage's exports are the port's, but for the table."""
    path = os.path.join(sub, "__init__.py")
    if not _port_has_file(path):
        assert _in_table(path, None), path
        return
    missing = [n for n in _missing_names(path) if not _in_table(path, n)]
    assert not missing, (path, missing)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_module_files(sub):
    """(b) every module file has the port's file of the same path."""
    missing = [p for p in MODULE_FILES if _subpackage(p) == sub
               and not _port_has_file(p) and not _in_table(p, None)]
    assert not missing, missing


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_module_names(sub):
    """(c) every public name of a module file is the port's module's."""
    missing = {}
    for p in MODULE_FILES:
        if (_subpackage(p) != sub or p.endswith("__init__.py")
                or not _port_has_file(p)):
            continue
        names = [n for n in _missing_names(p) if not _in_table(p, n)]
        if names:
            missing[p] = names
    assert not missing, missing


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_differences_have_reasons(sub):
    """(d) each entry of the table names a module file of dmel_tpu and
    gives its reason; a behaviour entry has its check."""
    entries = [k for k in DIFFERENCES if _subpackage(k[0]) == sub]
    for path, what in entries:
        assert path in MODULE_FILES, path
        reason = DIFFERENCES[(path, what)]
        assert isinstance(reason, str) and len(reason.split()) >= 5, reason
        if what is not None and not what.isidentifier():
            assert (path, what) in BEHAVIOURS, (path, what)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_differences_are_current(sub):
    """(d) no entry names what the port has gained since, and none names
    what dmel_tpu no longer has."""
    for key in [k for k in DIFFERENCES if _subpackage(k[0]) == sub]:
        path, what = key
        if what is None:
            assert not _port_has_file(path), f"{path} was ported"
        elif key in BEHAVIOURS:
            jax_has, port_lacks = BEHAVIOURS[key]()
            assert jax_has, f"stale: {key}"
            assert port_lacks, f"the port now has {key}"
        else:
            assert what in _public_names(path), f"stale: {key}"
            assert what not in dir(_port_module(path)), (
                f"the port now has {key}")


def test_every_subpackage_is_covered():
    """The parametrisation covers every entry of the table, and the
    top level is one of the subpackages."""
    assert "" in SUBPACKAGES
    assert {_subpackage(p) for p, _ in DIFFERENCES} <= set(SUBPACKAGES)


def test_top_level_ops_names():
    import dmel_tpu
    import dmel_tpu_torch as dm
    from dmel_tpu_torch import ops
    for name in ("spectrogram", "optimized_window_length",
                 "melscale_fbanks", "gaussian_window", "next_power_of_2",
                 "multi_sigma_mel_spectrogram"):
        assert hasattr(dmel_tpu, name)
        assert getattr(dm, name) is getattr(ops, name)
        assert name in dm.__all__
    assert dm.optimized_window_length(46.67) == \
        dmel_tpu.optimized_window_length(46.67) == 512
    assert dm.next_power_of_2(8000) == dmel_tpu.next_power_of_2(8000)
