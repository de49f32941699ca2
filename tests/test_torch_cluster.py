"""The cluster AR kernel's host side on the CPU (shallow_wavenet_tpu_torch.
ops.ar_kernel in a Layout with cluster=N; the kernel, csrc/ar_cluster.cu,
runs only on a card and is held there by chip_smoke.py): its plain
version's summation order (`split=N`) against the JAX generators, the
partition of the widths over the ranks, the packing of each rank's weight
slices, and the layout chooser's ladder.

Tolerances. fp32 `split=N, chain=True` against `generate_pallas` in
interpret mode: as test_torch_generate (Laplace atol 1e-5: fp32 sums in
another order; softmax: at most 1 bin on under 1% of samples). bf16:
`split=1, chain=True` is chain=True's order, so it is held to the bit;
`split=N` sums the same exact bf16 products in another fp32 order, so a
value now and then lands on the other side of a bf16 rounding edge and
the rings carry it on: held at TOL_BF16_SPLIT over a short teacher-forced
call, where the fp32 version, the control, misses by more.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.models import WaveNet as FlaxWaveNet
from shallow_wavenet_tpu.models import extract_plain_params
from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.bin import decode
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_model import randomize_head, tiny_cfg
from tests.test_torch_generate import assert_same_samples
from tests.test_torch_model import port_cfg, port_pp

# largest bf16 split-order difference on these shapes is a few bf16 ulps
# of the samples (|x| <= 1: 2^-8 relative)
TOL_BF16_SPLIT = 2e-2


def _setup(head, F=6, B=2, seed=0):
    """tests/test_generate.py's setup_gen at widths every cluster size
    divides (R = G/2 = C = 16, S = 32), with a random head2."""
    import jax
    cfg = tiny_cfg(head=head, n_stacks=2, stack_size=3, cond_channels=16,
                   skip_channels=32)
    m = FlaxWaveNet(cfg)
    rng = np.random.default_rng(seed)
    H = int(np.prod(cfg.upsample_factors))
    T = F * H - 1
    x = (jnp.asarray(rng.integers(0, 256, (B, T)), jnp.int32)
         if head == "softmax" else
         jnp.asarray(rng.uniform(-1, 1, (B, T)), jnp.float32))
    c = jnp.asarray(rng.standard_normal((B, F, cfg.aux_channels)),
                    jnp.float32)
    v = randomize_head(m.init(jax.random.key(3), x, c))
    pp = extract_plain_params(v, cfg)
    c_up = np.array(m.apply(v, c, method="upsample_cond"))
    return cfg, pp, c_up


def _noise(shape, seed):
    return np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, shape).astype(
        np.float32)


def _teacher(head, shape, seed):
    rng = np.random.default_rng(seed)
    if head == "softmax":
        return rng.integers(0, 256, shape).astype(np.float32)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _plain(pp, cfg, c_up, noise, **kw):
    return ar_kernel.generate_plain(
        port_pp(pp), port_cfg(cfg), torch.from_numpy(c_up),
        noise=torch.from_numpy(noise), device="cpu", **kw).numpy()


@pytest.mark.parametrize("head", ["laplace", "softmax"])
@pytest.mark.parametrize("mode, split", [("sample", 16), ("greedy", 2),
                                         ("warmup", 4)])
def test_split_chain_matches_pallas_interpret(head, mode, split):
    """fp32 in the cluster kernel's order: sample, greedy, and a warm-up
    prefix of 64 forced steps, against the TPU kernel in interpret mode."""
    cfg, pp, c_up = _setup(head, F=12 if mode == "warmup" else 6)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 1)
    kw = {}
    if mode == "warmup":
        kw = dict(teacher=_teacher(head, (B, 64), 2), warmup=64)
    got = _plain(pp, cfg, c_up, noise, split=split, chain=True,
                 mode="greedy" if mode == "greedy" else "sample",
                 **{k: torch.from_numpy(v) if k == "teacher" else v
                    for k, v in kw.items()})
    want = generate_pallas(pp, cfg, jnp.asarray(c_up), noise=jnp.asarray(noise),
                           mode="greedy" if mode == "greedy" else "sample",
                           chunk=64, interpret=True,
                           **{k: jnp.asarray(v) if k == "teacher" else v
                              for k, v in kw.items()})
    assert_same_samples(cfg, got, np.asarray(want))


@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_bf16_split_orders(head):
    """bf16, teacher-forced: split=1 is chain=True's order to the bit;
    split=4 and 16 stay within TOL_BF16_SPLIT of it, and the fp32 version
    misses it by more."""
    cfg, pp, c_up = _setup(head, F=3)
    B, T, _ = c_up.shape
    noise = _noise((B, T), 3)
    teacher = torch.from_numpy(_teacher(head, (B, T), 4))

    def run(dtype="bfloat16", **kw):
        return _plain(pp, cfg, c_up, noise, teacher=teacher, dtype=dtype,
                      **kw)

    chain = run(chain=True)
    np.testing.assert_array_equal(run(chain=True, split=1), chain)
    control = np.abs(run("float32") - chain).max()
    for split in (4, 16):
        d = np.abs(run(chain=True, split=split) - chain).max()
        assert d <= TOL_BF16_SPLIT, (split, d)
        if head == "laplace":
            assert control > d, (split, d, control)


def test_generate_cluster_on_cpu_is_the_plain_version():
    """generate in a cluster=N layout on a CPU tensor runs the plain
    version (split changes no matmul order): the samples equal cluster=0's;
    the packed weights ride along, and the call runs their layout or one
    packed alike (here the other weight placement), never another."""
    cfg, pp, c_up = _setup("laplace")
    B, T, _ = c_up.shape
    noise = torch.from_numpy(_noise((B, T), 5))
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    c = torch.from_numpy(c_up)
    Layout = ar_kernel.Layout
    w = ar_kernel.kernel_weights(ppp, pcfg, Layout(cluster=8), "cpu")
    assert "cluster_stages" in w.tensors and w.layout == Layout(cluster=8)
    a = ar_kernel.generate(w, pcfg, c, noise=noise, device="cpu")
    b = ar_kernel.generate(ppp, pcfg, c, noise=noise, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(ar_kernel.generate(
        w, pcfg, c, noise=noise, device="cpu",
        layout=Layout(cluster=8, resident=False)), b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cluster=8"):
        ar_kernel.generate(w, pcfg, c, noise=noise, device="cpu",
                           layout=Layout(cluster=4))
    # weights made unfused do not run the fused window
    with pytest.raises(ValueError, match="fused=0"):
        ar_kernel.generate(w, pcfg, c, noise=noise, device="cpu",
                           layout=Layout(fused=2, cluster=8))


def _lengths(T):
    """Rows of their own lengths, as a decode pads them: one as long as the
    call, a short one, one in between, one of a single step."""
    return [T, 17, T - 5, 1]


@pytest.fixture(scope="module")
def four_rows():
    """The lengths tests' model and conditioning: 4 rows of T = 40."""
    return _setup("laplace", F=4, B=4)


@pytest.mark.parametrize("form", [
    {"cluster": 8},                             # generate's CPU path
    {"chain": True, "split": 4},                # the kernel's order
    {"chain": True, "split": 4, "fused": 2}])
def test_lengths_keep_each_row_of_the_padded_call(form, four_rows):
    """With lengths, each row's samples within its length are the padded
    call's to the bit, and 0 past it."""
    cfg, pp, c_up = four_rows
    B, T, _ = c_up.shape
    noise = _noise((B, T), 5)
    if "cluster" in form:
        def run(**kw):
            return ar_kernel.generate(
                port_pp(pp), port_cfg(cfg), torch.from_numpy(c_up),
                noise=torch.from_numpy(noise), device="cpu",
                layout=ar_kernel.Layout(**form), **kw).numpy()
    else:
        def run(**kw):
            return _plain(pp, cfg, c_up, noise, **form, **kw)
    padded = run()
    got = run(lengths=np.array(_lengths(T), np.int32))
    for r, n in enumerate(_lengths(T)):
        np.testing.assert_array_equal(got[r, :n], padded[r, :n])
        assert not got[r, n:].any(), r


def test_lengths_rows_do_not_depend_on_their_order(four_rows):
    """A shuffled batch gives each row the same samples, in the kernel's
    summation order; the cluster order is the rows longest first, equal
    lengths in row order."""
    cfg, pp, c_up = four_rows
    B, T, _ = c_up.shape
    noise = _noise((B, T), 6)
    lengths = _lengths(T)
    want = _plain(pp, cfg, c_up, noise, chain=True, split=4, lengths=lengths)
    perm = [2, 0, 3, 1]
    got = _plain(pp, cfg, c_up[perm], noise[perm], chain=True, split=4,
                 lengths=[lengths[r] for r in perm])
    np.testing.assert_array_equal(got, want[perm])
    assert ar_kernel.cluster_order(lengths) == [0, 2, 1, 3]
    assert ar_kernel.cluster_order([75, 86, 96, 107, 118, 129, 139, 150]) \
        == [7, 6, 5, 4, 3, 2, 1, 0]
    assert ar_kernel.cluster_order([3, 5, 5, 3]) == [1, 2, 0, 3]


def test_lengths_none_runs_every_row_to_the_end(four_rows):
    """lengths=None is the padded call, equal to every row at length T;
    row_steps counts the steps run and the padded steps of each call."""
    cfg, pp, c_up = four_rows
    B, T, _ = c_up.shape
    noise = torch.from_numpy(_noise((B, T), 7))
    pcfg, ppp, c = port_cfg(cfg), port_pp(pp), torch.from_numpy(c_up)
    ar_kernel.row_steps.clear()
    a = ar_kernel.generate(ppp, pcfg, c, noise=noise, device="cpu")
    assert ar_kernel.row_steps == {"run": B * T, "padded": B * T}
    b = ar_kernel.generate(ppp, pcfg, c, noise=noise, device="cpu",
                           lengths=[T] * B)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ar_kernel.generate(ppp, pcfg, c, noise=noise, device="cpu",
                       lengths=_lengths(T))
    assert ar_kernel.row_steps == {"run": 2 * B * T + sum(_lengths(T)),
                                   "padded": 3 * B * T}


@pytest.mark.parametrize("lengths, kw, match", [
    ([0, 1, 1, 1], {}, r"in \[1, 40\]"),
    ([41, 1, 1, 1], {}, r"in \[1, 40\]"),
    ([1, 1, 1], {}, "4 integers"),
    ([1.0, 1, 1, 1], {}, "integers"),
    ([40, 40, 40, 31], {"warmup": 32}, r"in \[32, 40\]"),
    ([40, 40, 40, 39], {"warmup": 0}, r"in \[40, 40\]")])
def test_lengths_refused(lengths, kw, match, four_rows):
    """A length below 1, past T or below the teacher-forced steps, a
    count other than B, or a non-integer raises ValueError."""
    cfg, pp, c_up = four_rows
    B, T, _ = c_up.shape
    noise = torch.from_numpy(_noise((B, T), 8))
    if kw:
        kw["teacher"] = torch.from_numpy(_teacher("laplace", (B, T), 9))
    for fn in (ar_kernel.generate, ar_kernel.generate_plain):
        with pytest.raises(ValueError, match=match):
            fn(port_pp(pp), port_cfg(cfg), torch.from_numpy(c_up),
               noise=noise, device="cpu", lengths=lengths, **kw)


def test_cluster_max_rows_is_the_kernels():
    """The wrapper counts a call's launches by the kernel's clusters per
    launch (kMaxRows in csrc/ar_cluster.cu)."""
    src = (Path(ar_kernel.__file__).parents[1] / "csrc"
           / "ar_cluster.cu").read_text()
    got = re.search(r"constexpr int kMaxRows = (\d+);", src)
    assert int(got.group(1)) == ar_kernel.CLUSTER_MAX_ROWS


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_partition_covers_every_index_once(n):
    cfg = port_cfg(tiny_cfg(n_stacks=2, stack_size=3, cond_channels=16,
                            skip_channels=32))
    part = ar_kernel.cluster_partition(cfg, n)
    widths = {"h": cfg.residual_channels, "cond": cfg.cond_channels,
              "z": cfg.gate_channels // 2, "skip": cfg.skip_channels,
              "gate": cfg.gate_channels}
    for key, width in widths.items():
        assert len(part[key]) == n
        owned = [i for r in part[key] for i in r]
        assert sorted(owned) == list(range(width)), key
        # every rank the same share, in contiguous order
        assert {len(r) for r in part[key]} == {width // n}
    # a gate pair (j, j + G/2) is one rank's
    half = cfg.gate_channels // 2
    for z, gate in zip(part["z"], part["gate"]):
        assert gate == list(z) + [half + j for j in z]


@pytest.mark.parametrize("n", [8, 16])
def test_partition_refuses_widths_n_does_not_divide(n):
    cfg = port_cfg(tiny_cfg(n_stacks=2, stack_size=3))   # C = 12, S = 24
    with pytest.raises(ValueError, match="cond_channels=12"):
        ar_kernel.cluster_partition(cfg, n)
    assert ar_kernel.cluster_sizes(cfg) == (4, 2)
    # C = 24: 16 does not divide it, so the size falls back to 8
    c24 = port_cfg(tiny_cfg(n_stacks=2, stack_size=3, cond_channels=24,
                            skip_channels=32))
    assert ar_kernel.cluster_sizes(c24) == (8, 4, 2)


def test_pack_cluster_places_each_weight_where_the_kernel_reads_it():
    """Rank k's packed stage l holds W0/W1 rows of its h at
    ((r G + g) 2 + tap), then cond rows of its c at 2 (R/n) G + k' G + g,
    then skip|res rows of its z at (2 R/n + C/n) G + j (S + R) + n; its
    head stage H1 rows of its skip at s S + n, then H2 at (S/n) S + s O + n
    (ar_cluster.cu's indexing)."""
    cfg, pp, _ = _setup("laplace")
    pcfg = port_cfg(cfg)
    n = 4
    w = ar_kernel.kernel_weights(port_pp(pp), pcfg,
                                 ar_kernel.Layout(cluster=n), "cpu").tensors
    st = w["cluster_stages"]
    L, R, G, S = (len(pcfg.dilations), pcfg.residual_channels,
                  pcfg.gate_channels, pcfg.skip_channels)
    O, Rn, Hn, Sn, Cn = 2, R // n, G // 2 // n, S // n, pcfg.cond_channels // n
    assert st.shape == (n, L + 1, ar_kernel.cluster_stage_stride(pcfg, n))
    assert st.shape[-1] % 8 == 0
    rs_w = torch.cat([w["skip_w"], w["res_w"]], dim=-1)
    for k in range(n):
        for l in range(L):
            for tap in (0, 1):
                got = st[k, l, :2 * Rn * G].reshape(Rn, G, 2)[:, :, tap]
                torch.testing.assert_close(
                    got, w["conv_w"][l, tap, k * Rn:(k + 1) * Rn],
                    rtol=0, atol=0)
            v0, z0 = 2 * Rn * G, (2 * Rn + Cn) * G
            torch.testing.assert_close(
                st[k, l, v0:z0].reshape(Cn, G),
                w["cond_w"][l, k * Cn:(k + 1) * Cn], rtol=0, atol=0)
            torch.testing.assert_close(
                st[k, l, z0:z0 + Hn * (S + R)].reshape(Hn, S + R),
                rs_w[l, k * Hn:(k + 1) * Hn], rtol=0, atol=0)
        torch.testing.assert_close(
            st[k, L, :Sn * S].reshape(Sn, S),
            w["head1_w"][k * Sn:(k + 1) * Sn], rtol=0, atol=0)
        torch.testing.assert_close(
            st[k, L, Sn * S:Sn * (S + O)].reshape(Sn, O),
            w["head2_w"][k * Sn:(k + 1) * Sn], rtol=0, atol=0)


def test_ladder_puts_the_cluster_layouts_first(monkeypatch):
    """Within each dtype the cluster layout comes first, then
    ar_generate's three (resident, streamed at chunk 64, at 32), in their
    order; every fp32 layout comes before any bf16 one, so "auto" never
    lowers the precision while an fp32 layout fits, the cluster kernel's
    wide form last of the fp32 ones, so that every model another fp32
    layout fits keeps it. On the CPU the first layout is the fp32 cluster
    layout, at the largest size that divides the widths, --fused too
    (cluster=False gives ar_generate's). On a card (sizes and byte counts
    stand in for the kernels' own), a model with no fp32 cluster size
    takes ar_generate's fp32 layout, and bf16 only where no fp32 layout
    fits."""
    Layout = ar_kernel.Layout
    c2 = get_config("shallow_laplace_single").model
    deep = get_config("deep_baseline").model
    for mc in (c2, deep):
        assert ar_kernel.choose_layout(mc, "auto", "cpu") == Layout(
            cluster=16)
        assert ar_kernel.choose_layout(mc, "bfloat16", "cpu").cluster == 16
    assert ar_kernel.choose_layout(c2, "auto", "cpu", fused=4) == Layout(
        fused=4, cluster=16)
    assert ar_kernel.choose_layout(c2, "auto", "cpu", cluster=False) == \
        Layout()

    asked = []
    fp32_bytes = [1000]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ar_kernel, "smem_limit", lambda dev: 2000)

    def gen_bytes(cfg, lay):
        asked.append(("generate", lay.dtype, lay.stream, lay.chunk))
        return fp32_bytes[0] if lay.dtype == "float32" else 1000

    def cluster(cfg, dtype, dev, fused, sizes, wide=False):
        asked.append(("wide" if wide else "cluster", dtype))
        return (Layout(dtype, fused, 8)
                if dtype == "bfloat16" and sizes and not wide else None)

    monkeypatch.setattr(ar_kernel, "smem_bytes", gen_bytes)
    monkeypatch.setattr(ar_kernel, "_cluster_layout", cluster)
    bf16_cluster = Layout("bfloat16", cluster=8)
    assert ar_kernel.choose_layout(c2) == Layout()
    assert asked == [("cluster", "float32"),
                     ("generate", "float32", False, 64)]
    assert ar_kernel.choose_layout(c2, "float32") == Layout()
    assert ar_kernel.choose_layout(c2, "bfloat16") == bf16_cluster
    # no fp32 layout fits, the wide form's neither: auto takes the bf16
    # cluster layout, after every fp32 one in the ladder's order (deep
    # streams its large dilations at chunk 64 and at 32)
    fp32_bytes[0] = 3000
    assert ar_kernel.choose_layout(c2) == bf16_cluster
    asked.clear()
    assert ar_kernel.choose_layout(deep) == bf16_cluster
    assert asked == [("cluster", "float32"),
                     ("generate", "float32", False, 64),
                     ("generate", "float32", True, 64),
                     ("generate", "float32", True, 32),
                     ("wide", "float32"), ("cluster", "bfloat16")]


def test_cluster_size_fills_the_card(monkeypatch):
    """On a card (sizes and occupancy stand in for the kernel's own, the
    shared memory limit is the card's property): the largest size whose
    clusters cover FILL_SHARE of the SMs, whatever the batch; else the
    largest that fits; placement resident where the block fits, else
    streamed from L2."""
    import types
    Layout = ar_kernel.Layout
    c2 = get_config("shallow_laplace_single").model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132,
                            shared_memory_per_block_optin=232448))
    resident = {16: 129124, 8: 250036, 4: 491860, 2: 975508}
    streamed = {16: 25700, 8: 43188, 4: 78164, 2: 148116}
    monkeypatch.setattr(
        ar_kernel, "cluster_smem_bytes",
        lambda cfg, lay: (resident if lay.resident else streamed)[
            lay.cluster])
    asked = []

    def active(cfg, lay, dev=None):
        asked.append((lay.cluster, lay.resident))
        return {16: 7, 8: 30, 4: 62, 2: 66}[lay.cluster]

    monkeypatch.setattr(ar_kernel, "clusters_at_once", active)
    # 16 x 7 = 112 < 0.9 x 132: 8, from L2 (its resident block is too big)
    assert ar_kernel.choose_layout(c2, "float32") == Layout(
        cluster=8, resident=False)
    assert asked == [(16, True), (8, False)]
    # no size fills the card: the largest that fits
    monkeypatch.setattr(ar_kernel, "clusters_at_once",
                        lambda cfg, lay, dev=None: 1)
    assert ar_kernel.choose_layout(c2, "float32") == Layout(cluster=16)


def test_decode_warns_when_a_batch_runs_in_waves(monkeypatch, caplog):
    """The decode logs a warning when its batch is more than the card's
    clusters of the layout (occupancy stands in for the kernel's own), and
    not on the CPU or off the cluster kernel."""
    c2 = get_config("shallow_laplace_single").model
    lay = ar_kernel.Layout(cluster=8, resident=False)
    assert decode.warn_waves(c2, lay, 64, "cpu") == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # off the cluster kernel: no occupancy query at all
    assert decode.warn_waves(c2, ar_kernel.Layout(), 32) == 1
    monkeypatch.setattr(ar_kernel, "clusters_at_once",
                        lambda cfg, layout, dev=None: 15)
    with caplog.at_level("WARNING", logger="decode"):
        assert decode.warn_waves(c2, lay, 15) == 1
        assert not caplog.records
        assert decode.warn_waves(c2, lay, 32) == 3
        assert "3 waves" in caplog.records[-1].getMessage()


# A card in miniature for the chooser: the shared memory one block of a
# layout takes and the clusters the card holds at once, standing in for
# the kernels' own byte counts and occupancy query (the H100's limit and
# SMs; the counts are a rough model, not the kernels').
CARD_SMEM = 232448
CARD_AT_ONCE = {16: 7, 8: 15, 4: 33, 2: 66}


def _card_widths(cfg):
    O = cfg.quantize_channels if cfg.head == "softmax" else 2
    return (len(cfg.dilations), cfg.residual_channels, cfg.gate_channels,
            cfg.skip_channels, cfg.cond_channels, O)


def _card_cluster_bytes(cfg, lay):
    it = 2 if lay.dtype == "bfloat16" else 4
    L, R, G, S, C, O = _card_widths(cfg)
    n = lay.cluster
    if lay.wide:
        if G < 512:
            raise ValueError("the card in miniature's wide form takes "
                             "G >= 512")
        return 4 * sum(d for d in cfg.dilations if d < 64) * R // n + 65536
    layer = 2 * R * G + C * G + G // 2 * (S + R)
    extra = (lay.fused - 1) * G * G // 2 if lay.fused else 0
    ring = sum(cfg.dilations) * R // n
    if lay.resident:
        return it * ((L * (layer + extra) + S * (S + O)) // n + ring) + 8192
    return it * (2 * (layer + extra) // n + ring) + 8192


def _card_generate_bytes(cfg, lay):
    it = 2 if lay.dtype == "bfloat16" else 4
    L, R, G, S, C, O = _card_widths(cfg)
    rows = sum(d for d in cfg.dilations
               if not lay.stream or d <= lay.chunk or d % lay.chunk)
    return it * rows * R + it * lay.fused * G * 4 + 8192


def _card(monkeypatch, generate=True):
    import types
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132,
                            shared_memory_per_block_optin=CARD_SMEM))
    monkeypatch.setattr(ar_kernel, "cluster_smem_bytes", _card_cluster_bytes)
    monkeypatch.setattr(ar_kernel, "clusters_at_once",
                        lambda cfg, lay, dev=None: CARD_AT_ONCE[lay.cluster])
    if generate:
        monkeypatch.setattr(ar_kernel, "smem_bytes", _card_generate_bytes)


def _models():
    import json
    from shallow_wavenet_tpu_torch.config import PRESETS, Config
    path = (Path(__file__).resolve().parents[1] / "port_bench" / "configs"
            / "tamamori_sd_arctic.json")
    sd = Config.from_dict(json.loads(path.read_text())["config"]).model
    return {**{name: get_config(name).model for name in PRESETS},
            "tamamori_sd_arctic": sd}


# (dtype, fused) of each column of the tables below
CHOOSER_ASKS = [(dt, W) for dt in ("auto", "float32", "bfloat16")
                for W in (0, 4)]
# What the ladder before `Layout` (bin/decode.py's kernel_layout, the
# weights' placement worked out at each launch) chose for each column, as
# `launches` names the layout, with its chunk where not 64; None where it
# raised. On the CPU, for every model: the largest cluster size divides its
# widths.
PARENT_ON_CPU = ("ar_cluster[N16]", "ar_cluster[fused4,N16]",
                 "ar_cluster[N16]", "ar_cluster[fused4,N16]",
                 "ar_cluster[bf16,N16]", "ar_cluster[bf16,fused4,N16]")
# On the card in miniature
PARENT_ON_CARD = {
    "shallow_softmax_single": (
        "ar_cluster[N8]", "ar_cluster[fused4,N8]", "ar_cluster[N8]",
        "ar_cluster[fused4,N8]", "ar_cluster[bf16,N8]",
        "ar_cluster[bf16,fused4,N8]"),
    "shallow_laplace_single": (
        "ar_cluster[N8,l2]", "ar_cluster[fused4,N8,l2]", "ar_cluster[N8,l2]",
        "ar_cluster[fused4,N8,l2]", "ar_cluster[bf16,N8]",
        "ar_cluster[bf16,fused4,N8]"),
    "shallow_laplace_ns": (
        "ar_cluster[N8,l2]", "ar_cluster[fused4,N8,l2]", "ar_cluster[N8,l2]",
        "ar_cluster[fused4,N8,l2]", "ar_cluster[bf16,N8]",
        "ar_cluster[bf16,fused4,N8]"),
    "multispk_dp": (
        "ar_cluster[N8,l2]", "ar_cluster[fused4,N8,l2]", "ar_cluster[N8,l2]",
        "ar_cluster[fused4,N8,l2]", "ar_cluster[bf16,N8]",
        "ar_cluster[bf16,fused4,N8]"),
    "deep_baseline": (
        "ar_cluster[N16,l2]", "ar_cluster[fused4,N16,l2]",
        "ar_cluster[N16,l2]", "ar_cluster[fused4,N16,l2]",
        "ar_cluster[bf16,N8,l2]", "ar_cluster[bf16,fused4,N8,l2]"),
    "tamamori_sd_arctic": (
        "ar_cluster[N16,wide]", None, "ar_cluster[N16,wide]", None,
        "ar_generate[bf16,stream]/32", None),
}


@pytest.mark.parametrize("name", sorted(PARENT_ON_CARD))
def test_chooser_gives_the_parents_layouts(name, monkeypatch):
    """`choose_layout` picks, for each preset and the vocoder, under each
    dtype and fused window, the layout the ladder it replaced picked, on
    the CPU and on the card in miniature: the same kernel, size, weight
    placement, precision, window and rings."""
    mc = _models()[name]

    def chosen(device):
        out = []
        for dtype, fused in CHOOSER_ASKS:
            try:
                lay = ar_kernel.choose_layout(mc, dtype, device, fused)
            except ar_kernel.NoLayoutError:
                out.append(None)
                continue
            out.append(lay.name + ("" if lay.chunk == 64
                                   else f"/{lay.chunk}"))
        return tuple(out)

    assert chosen("cpu") == PARENT_ON_CPU
    _card(monkeypatch)
    assert chosen("cuda") == PARENT_ON_CARD[name]


def test_a_cluster_layout_never_loads_ar_generate(monkeypatch):
    """Where a cluster layout fits, choosing it neither builds nor loads
    `ar_generate.cu`'s library: the card's shared memory limit is its own
    property, and no `ar_generate` layout is weighed."""
    _card(monkeypatch, generate=False)

    def no_library():
        raise RuntimeError("ar_generate's library was loaded")

    monkeypatch.setattr(ar_kernel, "_lib", no_library)
    models = _models()
    for name in ("shallow_softmax_single", "shallow_laplace_single",
                 "deep_baseline"):
        for dtype, fused in CHOOSER_ASKS:
            lay = ar_kernel.choose_layout(models[name], dtype, "cuda", fused)
            assert lay.cluster and not lay.wide, (name, dtype, fused)
    assert ar_kernel.smem_limit("cuda") == CARD_SMEM
    # an ar_generate layout is weighed only where no cluster one fits
    with pytest.raises(RuntimeError, match="library was loaded"):
        ar_kernel.choose_layout(models["tamamori_sd_arctic"], "bfloat16",
                                "cuda")
