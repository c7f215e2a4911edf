"""The port's H100 probes (l2n_tpu_torch/probes/) against the JAX probes.

Each JAX probe script (benchmarks/cond_cost.py, sweep_variants.py,
onehot_recovery.py) is loaded from its file, never imported as a package
and never edited; a test sets module constants on its own loaded copy to
keep Pallas interpret mode affordable (REPEATS 2, 16 spheres, one block,
onehot S = 16, cond_cost grid 2) and builds the `pl.pallas_call` with
interpret=True. The JAX side runs op by op (`jax.disable_jit()`): jitted,
XLA:CPU contracts multiply-adds into FMAs and moves the last ulp. The same
numpy inputs go through the port's wrappers on CPU tensors, which run the
plain versions; csrc/sweep_probe.cuh's bodies are held against the plain
versions in tests/test_torch_csrc.py, and chip_smoke.py holds the kernels
against the plain versions on the card.

Gates: bit equality for cond_cost, vpu, vpu2 and the onehot carry, the
onehot gather on hits (on misses: index -1 and zero attributes, where the
carry leaves r2 = 1). The mma variant's algebra differs from the scalar
sweep's by design, and its dot products are the exact ones rounded to
float32 where XLA's dot sums float32 products: at least 99.9% of lanes
agree with the JAX mxu kernel to |d acc| <= 1e-4 max(|acc|, 1). Its
float32-dot form (`exact_dots=False`) picks the same winners on at least
99.9% of lanes, and there agrees to that tolerance on at least 99.9%.
"""

from __future__ import annotations

import ctypes
import importlib.util
import re
import sys
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from l2n_tpu.config import RenderConfig as JRenderConfig
from l2n_tpu.scene import compute_spheres as jcompute_spheres
from l2n_tpu_torch.ops.kernels import build, common
from l2n_tpu_torch.probes import cond_cost as port_cc
from l2n_tpu_torch.probes import onehot_recovery as port_oh
from l2n_tpu_torch.probes import probe_device
from l2n_tpu_torch.probes import sweep_variants as port_sv


def _forget_port():
    """Drop the port's modules from sys.modules; this file keeps its own
    bindings. tests/test_aot_cache.py asserts that every loaded module
    named "l2n_tpu*" lies in the JAX package's AOT digest scope, and every
    xdist worker imports every test file, so the port (a separate package
    whose name shares that prefix) must not stay loaded."""
    for name in [m for m in sys.modules if m.startswith("l2n_tpu_torch")]:
        del sys.modules[name]


_forget_port()


@pytest.fixture(scope="module", autouse=True)
def _port_unloaded_after_module():
    # One torch thread while this module runs: the suite's workers share
    # the machine's cores, and a torch pool as wide as the machine in each
    # of them oversubscribes the cores (the JAX package's tests included).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _forget_port()


BENCH = Path(__file__).resolve().parents[1] / "benchmarks"
TH, TW = 32, 128


def load_probe(name: str, **constants):
    """A fresh copy of benchmarks/<name>.py, loaded from its file under a
    private module name, with `constants` set on this copy only."""
    spec = importlib.util.spec_from_file_location(f"_jax_probe_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in constants.items():
        setattr(mod, key, value)
    return mod


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


class Ref:
    """A stand-in for a Pallas ref, to run a kernel body op by op under
    `jax.disable_jit()`: indexing reads a jnp array, assignment stores."""

    def __init__(self, value):
        self.value = jnp.asarray(value)

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


def op_by_op(kernel, *args, out_shape):
    """`kernel`'s body on one grid program's blocks `args`, op by op (the
    Pallas interpreter compiles a kernel body whole, and XLA:CPU then
    contracts multiply-adds into FMAs); returns the output block."""
    out = Ref(jnp.zeros(out_shape, jnp.float32))
    with jax.disable_jit():
        kernel(*(Ref(a) for a in args), out)
    return np.asarray(out.value)


def ulps(a, b):
    """Units in the last place between float32 arrays of one sign."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    return np.abs(ia - ib)


# ---------------------------------------------------------------------------
# cond_cost
# ---------------------------------------------------------------------------

def _jax_cond_cost(mod, mode, m, w, grid):
    x = jnp.ones((1, TH, TW), jnp.float32)
    spec = pl.BlockSpec((1, TH, TW), lambda i: (0, 0, 0))
    call = pl.pallas_call(
        partial(mod._kernel, mode, m, w), grid=(grid,), in_specs=[spec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((1, TH, TW),
                                                       jnp.float32),
        interpret=True)
    with jax.disable_jit():
        return np.asarray(call(x))


@pytest.mark.parametrize("setting", [("work", 0, 0), ("work", 0, 16),
                                     ("any", 0, 0), ("cond_taken", 3, 16),
                                     ("cond_skipped", 3, 16),
                                     ("cond_taken", 1, 5)],
                         ids=lambda s: f"{s[0]}-m{s[1]}-w{s[2]}")
def test_cond_cost_matches_jax(setting):
    mod = load_probe("cond_cost")
    want = _jax_cond_cost(mod, *setting, grid=2)
    x = torch.ones((1, TH, TW), dtype=torch.float32)
    got = port_cc.cond_cost(x, *setting, grid=2).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if setting[0] in ("any", "cond_skipped"):
        assert (got == 1.0).all()  # 1e-9 is below half an ulp of 1
    if setting == ("work", 0, 16):
        assert got.flat[0] == np.float32(1.0000305)


def test_cond_cost_wrapper_checks():
    x = torch.ones((1, TH, TW), dtype=torch.float32)
    before = dict(common.launches)
    np.testing.assert_array_equal(
        port_cc.cond_cost(x, "cond_taken", 6, 3, grid=3).numpy(),
        port_cc.cond_cost_plain(x, "cond_taken", 6, 3, grid=3).numpy())
    assert dict(common.launches) == before  # the plain version is no launch
    with pytest.raises(TypeError, match="x"):
        port_cc.cond_cost(x.double(), "work")
    with pytest.raises(ValueError, match="shape"):
        port_cc.cond_cost(torch.ones((2, TH, TW)), "work")
    with pytest.raises(ValueError, match="mode"):
        port_cc.cond_cost(x, "while")
    with pytest.raises(ValueError, match="m_carry"):
        port_cc.cond_cost(x, "cond_skipped", 2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        port_cc.cond_cost(x.to("meta"), "work")


# ---------------------------------------------------------------------------
# sweep_variants
# ---------------------------------------------------------------------------

N, BLOCKS, REPEATS = 16, 1, 2


def test_sweep_inputs_match_jax():
    """Byte-equal to benchmarks/sweep_variants.py:238-253 (its main)."""
    data = port_sv.inputs()
    cfg = JRenderConfig().validate()
    scene = jcompute_spheres(128, 1024.0, cfg.scene_seed)
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-400, 400, (3, 64, TH, TW)), jnp.float32)
    d = rng.normal(size=(3, 64, TH, TW))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    cx, cy, cz, r2 = (jnp.asarray(a) for a in (
        scene.center_x, scene.center_y, scene.center_z, scene.sqr_radius))
    cmat = jnp.stack([cx, cy, cz, r2, cx * cx + cy * cy + cz * cz - r2,
                      r2 * 0, r2 * 0, r2 * 0], axis=0)
    want = {"o": o, "d": d, "cx": cx, "cy": cy, "cz": cz, "r2": r2,
            "cmat": cmat}
    assert set(data) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert data[key].dtype == value.dtype == np.float32, key
        assert data[key].tobytes() == value.tobytes(), key


# XLA:CPU's FMA contraction inside the interpreter's compiled kernel body:
# on the sweeps' inputs it moves at most 2% of lanes, each by at most 256
# ulps (a contracted hb * hb - c near a grazing root moves t by up to ~150
# ulps; measured 155 on 1.3% of lanes for vpu). Op by op, the gate is bit
# equality.
JIT_LANES, JIT_ULPS = 0.02, 256


@pytest.fixture(scope="module")
def sweep_case():
    """The JAX probe's three kernels on its inputs cut to 16 spheres, one
    block, 2 repeats (rows_per_chunk 8): each body op by op, and each
    `pl.pallas_call` in interpret mode; and the port's inputs."""
    mod = load_probe("sweep_variants", REPEATS=REPEATS)
    data = port_sv.inputs()
    o, d = data["o"][:, :BLOCKS], data["d"][:, :BLOCKS]
    sph = [data[k][:N] for k in ("cx", "cy", "cz", "r2")]
    cmat = np.ascontiguousarray(data["cmat"][:, :N])
    bias = np.zeros((BLOCKS, TH, TW), np.float32)
    vec = lambda planes: pl.BlockSpec((planes, None, TH, TW),  # noqa: E731
                                      lambda i: (0, i, 0, 0))
    lane = pl.BlockSpec((None, TH, TW), lambda i: (i, 0, 0))
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    scalar = [vec(3), vec(3), smem, smem, smem, smem]
    kernels = {
        "vpu": (partial(mod._kernel_vpu, N), (o, d, *sph), scalar),
        "vpu2": (partial(mod._kernel_vpu2, N), (o, d, *sph), scalar),
        "mxu": (partial(mod._kernel_mxu, N, 8), (o, d, cmat),
                [vec(3), vec(3), pl.BlockSpec(memory_space=pltpu.VMEM)])}
    op, interp = {}, {}
    for name, (kern, args, specs) in kernels.items():
        block = [a[:, 0] if a.ndim == 4 else a for a in args] + [bias[0]]
        op[name] = op_by_op(kern, *block, out_shape=(TH, TW))[None]
        call = pl.pallas_call(
            kern, grid=(BLOCKS,), in_specs=list(specs) + [lane],
            out_specs=lane, interpret=True,
            out_shape=jax.ShapeDtypeStruct((BLOCKS, TH, TW), jnp.float32))
        interp[name] = np.asarray(call(*args, bias))
    port_in = {"o": _t(o), "d": _t(d), "spheres": [_t(a) for a in sph],
               "cmat": _t(cmat), "bias": _t(bias)}
    return op, interp, port_in


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_sweep_scalar_variants_match_jax(sweep_case, variant):
    op, interp, x = sweep_case
    fn = port_sv.sweep_vpu if variant == "vpu" else port_sv.sweep_vpu2
    got = fn(x["o"], x["d"], *x["spheres"], x["bias"], REPEATS).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  op[variant].view(np.int32))
    # the probe's own check: the gather equals the carry bit for bit
    np.testing.assert_array_equal(op["vpu2"], op["vpu"])
    assert 0.01 < (got > 0).mean() < 0.99  # lanes that hit and that missed
    d = ulps(got, interp[variant])
    assert (d > 0).mean() <= JIT_LANES and d.max() <= JIT_ULPS


def test_sweep_mma_matches_jax(sweep_case):
    """The mma algebra against the JAX mxu kernel: not bit-equal (the port's
    dot products are exact and rounded once, XLA's dot sums float32
    products), so at least 99.9% of lanes agree to |d acc| <= 1e-4
    max(|acc|, 1). The JAX kernel writes
    acc only; a winner that differs in a repeat moves acc by a difference
    of two roots, which on these inputs is far above that tolerance."""
    op, interp, x = sweep_case
    index = torch.empty((REPEATS, BLOCKS, TH, TW), dtype=torch.int32)
    got = port_sv.sweep_mma(x["o"], x["d"], x["cmat"], x["bias"], REPEATS,
                            index).numpy()
    agree = {}
    for how, want in (("op by op", op["mxu"]), ("interpret", interp["mxu"])):
        tol = 1e-4 * np.maximum(np.abs(want), 1.0)
        agree[how] = float((np.abs(got - want) <= tol).mean())
        assert agree[how] >= 0.999, (how, agree[how])
    idx = index.numpy()
    assert idx.min() >= -1 and idx.max() < N and (idx >= 0).any()
    # The JAX kernel writes no winners; the issue's two-part gate (winners,
    # then |d acc| where they agree) holds the exact dot products against
    # the float32 ones of the same algebra. Float32 sums of o.c (~1e5) lose
    # the low bits that a grazing ray's discriminant keeps, so a few lanes
    # with the same winners still move by more than the tolerance.
    index32 = torch.empty_like(index)
    f32dots = port_sv.sweep_mma_plain(x["o"], x["d"], x["cmat"], x["bias"],
                                      REPEATS, index32,
                                      exact_dots=False).numpy()
    same = (index == index32).all(0).numpy()
    within = np.abs(got - f32dots) <= 1e-4 * np.maximum(np.abs(f32dots), 1.0)
    assert same.mean() >= 0.999, same.mean()
    assert within[same].mean() >= 0.999, within[same].mean()
    vpu = op["vpu"]
    print(f"max |mma - vpu|: port plain {np.abs(got - vpu).max():.4g}, JAX "
          f"mxu {np.abs(op['mxu'] - vpu).max():.4g}; lanes agreeing with "
          f"the JAX mxu kernel: {agree}; with float32 dots: winners "
          f"{same.mean():.6f}, |d acc| breaches {(~within & same).sum()}")


def test_sweep_wrappers_route_and_check():
    data = port_sv.inputs(blocks=1)
    o, d = _t(data["o"]), _t(data["d"])
    sph = [_t(data[k][:8]) for k in ("cx", "cy", "cz", "r2")]
    cmat = _t(np.ascontiguousarray(data["cmat"][:, :8]))
    bias = torch.full((1, TH, TW), 0.5)
    before = dict(common.launches)
    for fn, plain in ((port_sv.sweep_vpu, port_sv.sweep_vpu_plain),
                      (port_sv.sweep_vpu2, port_sv.sweep_vpu2_plain)):
        assert torch.equal(fn(o, d, *sph, bias, 1),
                           plain(o, d, *sph, bias, 1))
    assert torch.equal(port_sv.sweep_mma(o, d, cmat, bias, 1),
                       port_sv.sweep_mma_plain(o, d, cmat, bias, 1))
    assert dict(common.launches) == before
    with pytest.raises(TypeError, match="bias"):
        port_sv.sweep_vpu(o, d, *sph, bias.double())
    with pytest.raises(ValueError, match="shape"):
        port_sv.sweep_vpu2(o, d[:2], *sph, bias)
    with pytest.raises(ValueError, match="r2"):
        port_sv.sweep_vpu(o, d, *sph[:3], sph[3][:4], bias)
    with pytest.raises(ValueError, match="multiple of 8"):
        port_sv.sweep_mma(o, d, cmat[:, :6].contiguous(), bias)
    with pytest.raises(ValueError, match="index"):
        port_sv.sweep_mma(o, d, cmat, bias, 2,
                          torch.empty((1, 1, TH, TW), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel"):
        port_sv.sweep_vpu(*(t.to("meta") for t in (o, d, *sph, bias)))


def test_sweep_mma_stats_kernel_only():
    """`stats` counts the kernel's miss tests and resolves: the plain
    version, which a CPU tensor runs, has none, and the wrapper says so
    rather than leave the counters untouched."""
    data = port_sv.inputs(blocks=1)
    o, d = _t(data["o"]), _t(data["d"])
    cmat = _t(np.ascontiguousarray(data["cmat"][:, :8]))
    bias = torch.zeros((1, TH, TW))
    with pytest.raises(ValueError, match="stats"):
        port_sv.sweep_mma(o, d, cmat, bias, 1,
                          stats=torch.zeros(4, dtype=torch.int64))


# ---------------------------------------------------------------------------
# onehot_recovery
# ---------------------------------------------------------------------------

S_SMALL = 16


@pytest.fixture(scope="module")
def onehot_case():
    """The JAX probe at S = 16: each kernel body op by op, and each
    `_build(kind, interpret=True)` call."""
    mod = load_probe("onehot_recovery", S=S_SMALL)
    out = {}
    for kind, kern in (("carry", mod._kernel_carry),
                       ("onehot", mod._kernel_onehot)):
        args = [np.asarray(a) for a in mod._args(kind)]
        out[kind] = (op_by_op(kern, *args, out_shape=(6, TH, TW)),
                     np.asarray(mod._build(kind, True)(*args)))
    return mod, out


def test_onehot_inputs_match_jax(onehot_case):
    mod = onehot_case[0]
    data = port_oh.inputs(S_SMALL)
    want = [np.asarray(a) for a in mod._args("onehot")]
    rays = [data["rays"][k] for k in range(6)]
    sph = [data["spheres"][k][None, :] for k in range(4)]
    for got, w in zip(rays + sph + [data["table"]], want):
        assert got.dtype == w.dtype and got.shape == w.shape
        assert got.tobytes() == w.tobytes()
    assert port_oh.inputs()["spheres"].shape == (4, 128)


def test_onehot_matches_jax(onehot_case):
    (jcarry, icarry), (jgather, igather) = (onehot_case[1][k]
                                            for k in ("carry", "onehot"))
    x = {k: _t(v) for k, v in port_oh.inputs(S_SMALL).items()}
    carry = port_oh.onehot_carry(x["rays"], x["spheres"]).numpy()
    gather = port_oh.onehot_gather(x["rays"], x["spheres"],
                                   x["table"]).numpy()
    np.testing.assert_array_equal(carry.view(np.int32),
                                  jcarry.view(np.int32))
    hit = jcarry[1] >= 0
    assert 0.01 < hit.mean() < 0.99
    for k in range(6):  # the probe's own check, and the port against it
        np.testing.assert_array_equal(gather[k][hit].view(np.int32),
                                      jgather[k][hit].view(np.int32))
        np.testing.assert_array_equal(gather[k][hit], carry[k][hit])
    miss = ~hit
    assert (gather[0][miss] == np.float32(3.0e38)).all()
    assert (gather[1][miss] == -1).all() and (jgather[1][miss] == -1).all()
    assert (gather[2:, miss] == 0).all() and (jgather[2:, miss] == 0).all()
    # the trap: the carry starts its attributes at (0, 0, 0, 1)
    assert (carry[2:5, miss] == 0).all() and (carry[5, miss] == 1).all()
    # Interpret mode (compiled, FMAs contracted): the same winners and
    # attributes everywhere; t within JIT_ULPS on hits (measured 122).
    for got, want in ((carry, icarry), (gather, igather)):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2:, hit], want[2:, hit])
        assert ulps(got[0], want[0]).max() <= JIT_ULPS


def test_onehot_wrappers_route_and_check():
    x = {k: _t(v) for k, v in port_oh.inputs(8).items()}
    before = dict(common.launches)
    assert torch.equal(port_oh.onehot_carry(x["rays"], x["spheres"]),
                       port_oh.onehot_carry_plain(x["rays"], x["spheres"]))
    assert torch.equal(
        port_oh.onehot_gather(x["rays"], x["spheres"], x["table"]),
        port_oh.onehot_gather_plain(x["rays"], x["spheres"], x["table"]))
    assert dict(common.launches) == before
    with pytest.raises(TypeError, match="rays"):
        port_oh.onehot_carry(x["rays"].half(), x["spheres"])
    with pytest.raises(ValueError, match="table"):
        port_oh.onehot_gather(x["rays"], x["spheres"], x["table"][:4])
    with pytest.raises(ValueError, match="no kernel"):
        port_oh.onehot_carry(x["rays"].to("meta"), x["spheres"].to("meta"))


# ---------------------------------------------------------------------------
# the probes' command lines
# ---------------------------------------------------------------------------

def test_probe_mains_on_cpu(capsys, monkeypatch):
    for mod, key, value in ((port_sv, "BLOCKS", 1), (port_sv, "SPHERES", 8),
                            (port_sv, "REPEATS", 1), (port_oh, "S", 8),
                            (port_cc, "GRID", 2)):
        monkeypatch.setattr(mod, key, value)
    res = port_sv.main(["--device", "cpu"])
    assert set(res) == {"vpu", "vpu2carry", "mma"}
    assert res["vpu"][0].shape == (1, TH, TW)
    assert torch.equal(res["vpu"][0], res["vpu2carry"][0])
    assert port_oh.main(["check", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="card"):
        port_oh.main(["time", "--device", "cpu"])
    ns = port_cc.main(["--device", "cpu"])
    assert list(ns) == port_cc.SETTINGS and min(ns.values()) > 0
    out = capsys.readouterr().out
    for text in ("ps/(lane*cand)", "max |vpu2 - vpu|: 0.0", "max |mma - vpu|",
                 "CHECK PASS", "ns/unit"):
        assert text in out
    assert len(port_cc.SETTINGS) == 15


def test_probe_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cc.main([])
    with pytest.raises(ValueError, match="expected cuda or cpu"):
        probe_device("meta")
    assert probe_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# the library's C entry points
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "l2n_tpu_torch" / "csrc"


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.glob("*.cu")))
def test_declared_argtypes_match_the_entry_points(source):
    """build._declare gives every `extern "C" int l2n_*` entry point of
    csrc/<source> one ctypes type per parameter, the stream included: a
    pointer for a pointer, a C int for an int. (ctypes passes an argument
    beyond the declared ones unconverted, so a short list still launches,
    but it no longer checks what it is handed.)"""
    declared = {}

    class Lib:
        def __getattr__(self, name):
            return declared.setdefault(name, types.SimpleNamespace())

    build._declare(Lib())
    text = (CSRC / source).read_text()
    entries = re.findall(r'extern "C" int (l2n_\w+)\(([^)]*)\)', text)
    assert entries, source
    for name, params in entries:
        want = [ctypes.c_void_p if "*" in p else ctypes.c_int
                for p in params.split(",")]
        assert name in declared, name
        assert declared[name].argtypes == want, name
        assert declared[name].restype is ctypes.c_int, name
