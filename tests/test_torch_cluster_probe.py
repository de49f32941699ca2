"""The ablation probe on the cluster kernel (shallow_wavenet_tpu_torch.ops.
ar_probe with kernel="cluster"), on the CPU, where the port runs its plain
version: its summation order `split=N, chain=True` against the production
kernel's plain version and against the present order, the ablations the
cluster keeps against the TPU probe `tools/kprobe.py` in interpret mode
(through tests/test_torch_kprobe.py's loader), local_exchange, the
refusals, the timer's stage table, the library table of `_build`, and
`bin.kprobe --kernel cluster`. The kernel, `csrc/ar_cluster.cu`'s probe
instances, runs only on a card and is held there by chip_smoke.py's
`cluster_probe` phase.

Tolerances: the cluster order against the production plain version and
against the present order (split=1) is exact, in fp32 and bf16 (both do
the same operations in the same order); against the TPU tool, fp32 1e-5,
as tests/test_torch_kprobe.py (the same products summed in other orders).
"""

import numpy as np
import pytest
import torch

from shallow_wavenet_tpu_torch.bin import kprobe, sass_diff
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import _build, ar_kernel, ar_probe

from tests.test_model import tiny_cfg
from tests.test_torch_kprobe import CFG, CHUNK, JNP, STD, _draw, _jax_want
from tests.test_torch_model import port_cfg

# R = S = G/2: each rank's z slice is its h and skip slice (no_resskip)
RS_CFG = tiny_cfg(gate_channels=32, residual_channels=16, skip_channels=16,
                  n_stacks=2, stack_size=2, cond_channels=4)
TOL_JAX = 1e-5


def _inputs(cfg, dtype, seed=0, T=16, B=2, scale=4.0):
    """The probe's recipe at 4x its std (as test_torch_kprobe's STD), and
    conditioning and uniforms, from numpy."""
    w = {k: (v.float() * scale).to(ar_kernel.DTYPES[dtype])
         for k, v in ar_probe.probe_weights(cfg, dtype, seed).items()}
    rng = np.random.default_rng(seed + 1)
    cond = torch.from_numpy(rng.standard_normal(
        (T, B, cfg.cond_channels)).astype(np.float32))
    noise = torch.from_numpy(rng.uniform(0.01, 0.99, (T, B)).astype(
        np.float32))
    return w, cond, noise


def _plain(w, cfg, cond, noise, ablate, **kw):
    return ar_probe.probe_plain(w, cfg, cond, noise, ablate, chunk=CHUNK,
                                device="cpu", **kw)


@pytest.mark.parametrize("split", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_in_split_order_is_the_production_plain_version(dtype, split):
    """probe_plain("full", split=N, chain=True) is
    ar_kernel.generate_plain(plain_params(w), split=N, chain=True) to the
    bit: the cluster probe's full is the production kernel's function."""
    cfg = port_cfg(CFG)
    w, cond, noise = _inputs(cfg, dtype)
    got = _plain(w, cfg, cond, noise, "full", split=split, chain=True)
    want = ar_kernel.generate_plain(
        ar_probe.plain_params(w), cfg, cond.transpose(0, 1), device="cpu",
        noise=noise.t(), dtype=dtype, chain=True, split=split)
    torch.testing.assert_close(got, want.t(), rtol=0, atol=0)


def _cfg_for(ablate):
    return port_cfg(RS_CFG if ablate == "no_resskip" else CFG)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ablate", [a for a in ar_probe.CLUSTER_ABLATIONS
                                    if a != "local_exchange"])
def test_split1_is_the_present_chain_order(ablate, dtype):
    """split=1 (one rank) sums in chain=True's order: every ablation the
    cluster keeps equals the present chain=True run to the bit."""
    cfg = _cfg_for(ablate)
    w, cond, noise = _inputs(cfg, dtype)
    got = _plain(w, cfg, cond, noise, ablate, split=1, chain=True)
    want = _plain(w, cfg, cond, noise, ablate, chain=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("ablate", [a for a in ar_probe.CLUSTER_ABLATIONS
                                    if a != "local_exchange"])
def test_split_without_chain_changes_nothing(ablate):
    cfg = _cfg_for(ablate)
    w, cond, noise = _inputs(cfg, "float32")
    want = _plain(w, cfg, cond, noise, ablate)
    for split in (2, 4):
        torch.testing.assert_close(
            _plain(w, cfg, cond, noise, ablate, split=split), want, rtol=0,
            atol=0)


@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("ablate", [
    a for a in ar_probe.CLUSTER_ABLATIONS
    if a not in ("no_resskip", "local_exchange")])
def test_cluster_ablations_match_jax_tool(ablate, split):
    """Each ablation the cluster keeps at CFG (no_resskip is refused
    there: R != G/2), fp32 in the cluster kernel's order at N ranks,
    against the TPU probe in interpret mode."""
    arrays, cond, noise = _draw(JNP["float32"], STD)
    w = ar_probe.weights_from_jax(arrays)
    got = _plain(w, port_cfg(CFG), torch.from_numpy(cond),
                 torch.from_numpy(noise), ablate, split=split,
                 chain=True).numpy()
    np.testing.assert_allclose(got, _jax_want(ablate, "float32"),
                               atol=TOL_JAX, rtol=0)


def test_no_resskip_in_split_order_is_its_function():
    """At R = S = G/2 the cluster's no_resskip is the probe's: the present
    order's samples, in fp32 to its rounding, and far from full."""
    cfg = port_cfg(RS_CFG)
    w, cond, noise = _inputs(cfg, "float32")
    got = _plain(w, cfg, cond, noise, "no_resskip", split=2, chain=True)
    torch.testing.assert_close(
        got, _plain(w, cfg, cond, noise, "no_resskip"), rtol=0, atol=1e-5)
    assert (got - _plain(w, cfg, cond, noise, "full")).abs().max() > 1e-3


def _sliced(w, cfg, cond, rank, n):
    """Rank `rank`'s own slices of a cluster of n as a model of their own
    (`ar_kernel.cluster_partition`): its h rows, its gate columns (the
    tanh half, then the sigmoid half), its conditioning rows, its z rows,
    its skip outputs; the hand-masked reference of local_exchange."""
    part = ar_kernel.cluster_partition(cfg, n)
    h, g, c, z, s = (list(part[k][rank])
                     for k in ("h", "gate", "cond", "z", "skip"))
    sw = {"in_b": w["in_b"][h],
          "conv_w": w["conv_w"][:, :, h][..., g],
          "cond_w": w["cond_w"][:, c][..., g],
          "res_w": w["res_w"][:, z][..., h],
          "skip_w": w["skip_w"][:, z][..., s],
          "h1_w": w["h1_w"][s][:, s],
          "h2_w": w["h2_w"][s]}
    scfg = port_cfg(tiny_cfg(
        gate_channels=len(g), residual_channels=len(h), skip_channels=len(s),
        n_stacks=2, stack_size=2, cond_channels=len(c)))
    assert scfg.dilations == cfg.dilations
    return {k: v.contiguous() for k, v in sw.items()}, scfg, \
        cond[..., c].contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_exchange(dtype):
    """local_exchange: at N = 1 it is full; at N = 2 each owned column sums
    only the owner's own partial, so rank 0, whose draw is the output, runs
    alone on its slices: the full probe of that sliced model, to the
    bit; and it is not full."""
    cfg = port_cfg(CFG)
    w, cond, noise = _inputs(cfg, dtype)
    full = _plain(w, cfg, cond, noise, "full", split=1, chain=True)
    torch.testing.assert_close(
        _plain(w, cfg, cond, noise, "local_exchange", split=1, chain=True),
        full, rtol=0, atol=0)
    got = _plain(w, cfg, cond, noise, "local_exchange", split=2, chain=True)
    sw, scfg, scond = _sliced(w, cfg, cond, 0, 2)
    want = _plain(sw, scfg, scond, noise, "full", split=1, chain=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (got - full).abs().max() > 1e-3


@pytest.mark.parametrize("cfg_over, ablate, split, match", [
    ([], "split2", 2, "split2 is refused on the cluster kernel"),
    ([], "no_resskip", 2, "no_resskip adds z"),          # S > G/2
    (["model.skip_channels=32"], "no_resskip", 2, "R = S = G/2"),
    ([], "full", 3, "does not divide"),
    ([], "no_such", 2, "unknown ablation"),
    (["model.skip_channels=16"], "no_head", 16, "skip_channels / N >= 2"),
])
def test_refusals_before_any_launch(cfg_over, ablate, split, match):
    """Both versions refuse, with the same text, before any step: the
    wrapper (here on the CPU) and the plain version."""
    cfg = get_config("shallow_laplace_single", cfg_over).model
    w = ar_probe.probe_weights(cfg)
    cond = torch.zeros(8, 2, cfg.cond_channels)
    noise = torch.full((8, 2), 0.5)
    ar_probe.launches.clear()
    texts = []
    for fn, kw in ((ar_probe.probe, dict(kernel="cluster",
                                         layout=ar_kernel.Layout(
                                             cluster=split))),
                   (ar_probe.probe_plain, dict(split=split))):
        with pytest.raises(ValueError, match=match) as e:
            fn(w, cfg, cond, noise, ablate, chunk=4, device="cpu", **kw)
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert not ar_probe.launches


def test_wrapper_on_cpu_is_the_plain_version():
    """probe(kernel="cluster") on a CPU tensor runs probe_plain at the
    decode's N (on the CPU the largest that divides the widths) or the
    given one; local_exchange is the cluster's own."""
    cfg = port_cfg(CFG)
    w, cond, noise = _inputs(cfg, "float32")
    n = ar_kernel.choose_layout(cfg, "float32", "cpu").cluster
    assert n > 1
    for ab in ("full", "local_exchange"):
        got = ar_probe.probe(w, cfg, cond, noise, ab, chunk=CHUNK,
                             device="cpu", kernel="cluster")
        torch.testing.assert_close(
            got, _plain(w, cfg, cond, noise, ab, split=n), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown ablation"):
        ar_probe.probe(w, cfg, cond, noise, "local_exchange", chunk=CHUNK,
                       device="cpu")
    with pytest.raises(ValueError, match="takes N in"):
        ar_probe.probe(w, cfg, cond, noise, "full", chunk=CHUNK,
                       device="cpu", kernel="cluster",
                       layout=ar_kernel.Layout(cluster=1))
    with pytest.raises(ValueError, match="unfused form"):
        ar_probe.probe(w, cfg, cond, noise, "full", chunk=CHUNK,
                       device="cpu", kernel="cluster",
                       layout=ar_kernel.Layout("bfloat16", cluster=n))
    with pytest.raises(ValueError, match="kernel must be one of"):
        ar_probe.check_shape(cfg, "full", 2, 16, 4, kernel="nope")


def test_probe_and_timer_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(CFG)
    w, cond, noise = _inputs(cfg, "float32")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ar_probe.probe(w, cfg, cond, noise, "full", chunk=CHUNK,
                           device=device, kernel="cluster",
                           layout=ar_kernel.Layout(cluster=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        ar_probe.timed_generate(ar_probe.plain_params(w), cfg,
                                cond.transpose(0, 1), noise.t())
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ar_probe.timed_generate(ar_probe.plain_params(w), cfg,
                                cond.transpose(0, 1), noise.t(),
                                device="cpu")
    assert not ar_probe.launches


def test_variant_names():
    assert ar_probe.variant("float32", "no_cond") == "ar_probe[no_cond]"
    assert ar_probe.variant("bfloat16", "no_cond", "cluster", 8, False) \
        == "ar_cluster_probe[bf16,N8,l2,no_cond]"
    assert ar_probe.variant("float32", "timed", "cluster", 8, True, 4) \
        == "ar_cluster_probe[fused4,N8,timed]"


@pytest.mark.parametrize("fused", [0, 4])
def test_stage_times_on_a_synthetic_buffer(fused):
    """The stage names of each form, us per step scaled by the call's time
    over each (row, rank)'s own loop cycles, and the stages plus the rest
    sum to the step."""
    rng = np.random.default_rng(3)
    B, N, T, event_ms = 3, 4, 2048, 40.0
    names = list(ar_probe.STAGES[bool(fused)])
    buf = np.zeros((B, N, ar_probe.TIMER_SLOTS), np.int64)
    for slot in ar_probe.STAGES[bool(fused)].values():
        buf[..., slot] = rng.integers(1000, 5000, (B, N))
    # the loop: the stages plus a rest, at a different clock per rank
    buf[..., -1] = buf[..., :-1].sum(-1) + rng.integers(100, 900, (B, N))
    rows = ar_probe.stage_times(torch.from_numpy(buf), event_ms, T, fused)
    assert [r["stage"] for r in rows] == names + ["rest"]
    step = 1e3 * event_ms / T
    assert sum(r["mean_us"] for r in rows) == pytest.approx(step, rel=1e-12)
    assert sum(r["share"] for r in rows) == pytest.approx(1.0, rel=1e-12)
    scale = step / buf[..., -1]
    for r in rows[:-1]:
        v = buf[..., ar_probe.STAGES[bool(fused)][r["stage"]]] * scale
        assert r["mean_us"] == pytest.approx(v.mean(1).mean())
        assert r["max_us"] == pytest.approx(v.max(1).mean())
    assert rows[-1]["mean_us"] > 0
    if fused:
        assert "block wait" in names and "rs1 wait" not in names
    else:
        assert "rs1 wait" in names and "block wait" not in names
    # counters that wrapped (stages past the loop) are refused
    buf[0, 0, -1] = 10
    with pytest.raises(ValueError, match="wrapped"):
        ar_probe.stage_times(torch.from_numpy(buf), event_ms, T, fused)


def test_build_table_hashes_source_and_flags(tmp_path, monkeypatch):
    """The probe library builds from the production source with its own
    -D flag; its path (like the production library's) changes with the
    source's bytes, and with its flags."""
    assert _build.LIBRARIES["ar_cluster_probe"] == (
        "ar_cluster.cu", ("-DAR_CLUSTER_PROBE",))
    assert _build.LIBRARIES["ar_cluster"] == ("ar_cluster.cu", ())
    assert {src for src, _ in _build.LIBRARIES.values()} == {
        p.name for p in _build.CSRC.glob("*.cu")}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.glob("*.cu"):
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    names = ("ar_cluster", "ar_cluster_probe", "ar_generate")
    before = {n: _build._lib_path(n) for n in names}
    assert before["ar_cluster"] != before["ar_cluster_probe"]
    assert all(p.parent == tmp_path / "build" for p in before.values())
    (csrc / "ar_cluster.cu").write_bytes(
        (csrc / "ar_cluster.cu").read_bytes() + b"\n")
    edited = {n: _build._lib_path(n) for n in names}
    assert edited["ar_cluster"] != before["ar_cluster"]
    assert edited["ar_cluster_probe"] != before["ar_cluster_probe"]
    assert edited["ar_generate"] == before["ar_generate"]
    monkeypatch.setitem(_build.LIBRARIES, "ar_cluster_probe", (
        "ar_cluster.cu", ("-DAR_CLUSTER_PROBE", "-DEXTRA")))
    assert _build._lib_path("ar_cluster_probe") != edited["ar_cluster_probe"]
    assert _build._lib_path("ar_cluster") == edited["ar_cluster"]
    assert _build.log_path("ar_cluster_probe").suffix == ".log"


@pytest.mark.parametrize("kw, error", [
    (dict(kernel="nope"), ValueError),
    (dict(kernel="cluster", only=["no_such"]), ValueError),
    (dict(kernel="cluster", steps=100), ValueError),   # not whole chunks
    (dict(kernel="cluster", device="cpu"), RuntimeError),
])
def test_kprobe_cluster_refuses_before_any_launch(kw, error):
    ar_probe.launches.clear()
    with pytest.raises(error):
        kprobe.sweep(**kw)
    assert not ar_probe.launches


@pytest.mark.parametrize("argv, code", [
    (["--kernel", "cluster"], 1),                       # no CUDA here
    (["--kernel", "cluster", "--timer", "--dtype", "both"], 1),
    (["--timer"], 2),                                   # generate's kernel
    (["--split", "8"], 2),
    (["--kernel", "cluster", "--timer", "--only", "full"], 2),
    (["--kernel", "cluster", "--timer", "--fused", "0"], 2),
])
def test_kprobe_cli_refuses_before_any_launch(argv, code, capsys):
    ar_probe.launches.clear()
    if code == 2:
        with pytest.raises(SystemExit) as e:
            kprobe.main(argv)
        assert e.value.code == 2
    else:
        assert kprobe.main(argv) == code
        assert "CUDA is not available" in capsys.readouterr().err
    assert not ar_probe.launches


def test_kprobe_timer_needs_cuda():
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kprobe.timer_sweep(device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        kprobe.time_stages(None, port_cfg(CFG), None, None, device="cpu")


def test_sass_diff_matches_a_kernel_across_sources():
    """bin.sass_diff matches a production instance of the parent's source
    (three template arguments) with this source's (five: kAblFull,
    untimed), whatever the anonymous namespace's name."""
    old = ("_ZN53_GLOBAL__N__962581f1_20_ar_cluster_parent_cu_77f3002a17ar_"
           "cluster_kernelIfLb1ELb0EEEvNS_6ParamsE")
    new = ("_ZN46_GLOBAL__N__12345678_13_ar_cluster_cu_abcdef0117ar_cluster_"
           "kernelIfLb1ELb0ELi0ELb0EEEvNS_6ParamsE")
    timed = new.replace("Li0ELb0E", "Li0ELb1E")
    assert sass_diff._key(old) == sass_diff._key(new)
    assert sass_diff._key(timed) != sass_diff._key(old)
