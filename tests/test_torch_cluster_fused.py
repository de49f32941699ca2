"""The fused window on the cluster AR kernel's host side, on the CPU
(shallow_wavenet_tpu_torch.ops.ar_kernel with cluster=N and fused=W; the
kernel, csrc/ar_cluster.cu, runs only on a card and is held there by
chip_smoke.py): the plain version's summation order for it (`fused=W,
split=N, chain=True`) against the JAX generator, the packing of each
rank's fused stages, the decode's layout ladder and the fused streaming
session.

Tolerances. fp32 `fused=W, split=N, chain=True` against
`generate_pallas(fused=W, interpret=True)`: as test_torch_fused (Laplace
atol 1e-5: the fp32 sums run in another order; softmax: at most 1 bin on
under 1% of samples). `split=1` is the order of `fused=W, chain=True`, so
it is held to the bit in fp32 and bf16. bf16 `split=N` against JAX's bf16
fused window, teacher-forced: both round to bf16 at the same points and
sum exact products in fp32, but in other orders, so a value now and then
lands on the other side of a bf16 rounding edge and the rings carry it
on: held at TOL_BF16_SPLIT (test_torch_cluster's limit), where the fp32
version, the control, misses by more. On the CPU a call with cluster=N
runs the plain version, whose matmuls (no `chain`) ignore the split, so
the session's stream and `generate(cluster=N, fused=W)` are held exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallow_wavenet_tpu.ops.ar_kernel import generate_pallas
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.models.streaming import StreamingSynthesizer
from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
from shallow_wavenet_tpu_torch.ops import ar_kernel

from tests.test_torch_cluster import (
    TOL_BF16_SPLIT, _noise, _plain, _setup, _teacher,
)
from tests.test_torch_generate import assert_same_samples
from tests.test_torch_model import port_cfg, port_pp
from tests.test_torch_streaming import _run
from tests.test_torch_streaming import _setup as _stream_setup

F = 3   # frames of conditioning: T = 30 steps, past every ring (sum d = 14)


@functools.lru_cache(maxsize=None)
def _case(head):
    cfg, pp, c_up = _setup(head, F=F)
    B, T, _ = c_up.shape
    return cfg, pp, c_up, _noise((B, T), 1), _teacher(head, (B, T), 2)


@functools.lru_cache(maxsize=None)
def _pallas(head, mode, fused, dtype="float32", forced=False):
    cfg, pp, c_up, noise, teacher = _case(head)
    kw = dict(teacher=jnp.asarray(teacher)) if forced else {}
    return np.asarray(generate_pallas(
        pp, cfg, jnp.asarray(c_up), noise=jnp.asarray(noise), mode=mode,
        chunk=64, interpret=True, fused=fused, dtype=dtype, **kw))


@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("fused", [2, 3, 4])
@pytest.mark.parametrize("mode", ["sample", "greedy"])
@pytest.mark.parametrize("head", ["laplace", "softmax"])
def test_fused_split_chain_matches_pallas_interpret(head, mode, fused,
                                                    split):
    """fp32 in the fused cluster kernel's order against the TPU kernel's
    fused window in interpret mode, free running."""
    cfg, pp, c_up, noise, _ = _case(head)
    got = _plain(pp, cfg, c_up, noise, mode=mode, fused=fused, split=split,
                 chain=True)
    assert_same_samples(cfg, got, _pallas(head, mode, fused))


@pytest.mark.parametrize("fused", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_split_one_is_the_chain_order(dtype, fused):
    """split=1 sums every gate input as fused=W, chain=True does: equal to
    the bit (teacher-forced and free running)."""
    cfg, pp, c_up, noise, teacher = _case("laplace")
    for kw in ({}, {"teacher": torch.from_numpy(teacher)}):
        np.testing.assert_array_equal(
            _plain(pp, cfg, c_up, noise, dtype=dtype, fused=fused,
                   chain=True, split=1, **kw),
            _plain(pp, cfg, c_up, noise, dtype=dtype, fused=fused,
                   chain=True, **kw))


@pytest.mark.parametrize("split", [2, 4])
def test_fused_bf16_split_near_pallas_bf16(split):
    """bf16, teacher-forced, W = 3: split=N within TOL_BF16_SPLIT of JAX's
    bf16 fused window; the fp32 version misses it by more."""
    cfg, pp, c_up, noise, teacher = _case("laplace")
    want = _pallas("laplace", "sample", 3, "bfloat16", forced=True)
    kw = dict(teacher=torch.from_numpy(teacher), fused=3)
    got = _plain(pp, cfg, c_up, noise, dtype="bfloat16", chain=True,
                 split=split, **kw)
    d = np.abs(got - want).max()
    assert d <= TOL_BF16_SPLIT, d
    assert np.abs(_plain(pp, cfg, c_up, noise, **kw) - want).max() > d


@pytest.mark.parametrize("n, fused", [(4, 4), (2, 3)])
def test_pack_cluster_fused_places_each_weight_where_the_kernel_reads_it(
        n, fused):
    """Rank k's stages, in the order a step reads them (per block, each
    layer's tap stage, then each layer's fm rows; then the head), at
    `cluster_fused_stages`' offsets (ar_cluster.cu's indexing): a tap
    stage holds W0/W1 rows of its h at (r G + g) 2 + tap, then cond rows of
    its c at 2 (R/n) G + k' G + g; an fm stage its rows of fm[l] at
    j (S + R + rem G) + m; the head H1 rows of its skip at s S + m, then H2
    at (S/n) S + s O + m. Each stage starts at a multiple of 8 elements."""
    cfg, pp, _, _, _ = _case("laplace")
    pcfg = port_cfg(cfg)
    w = ar_kernel.kernel_weights(port_pp(pp), pcfg, ar_kernel.Layout(
        fused=fused, cluster=n), "cpu").tensors
    st = w["cluster_stages"]
    L, R, G, S = (len(pcfg.dilations), pcfg.residual_channels,
                  pcfg.gate_channels, pcfg.skip_channels)
    O, Rn, Hn, Sn = 2, R // n, G // 2 // n, S // n
    Cn = pcfg.cond_channels // n
    layout = ar_kernel.cluster_fused_stages(pcfg, n, fused)
    assert len(layout) == 2 * L + 1
    assert st.shape == (n, layout[-1][0] + layout[-1][1])
    assert all(at % 8 == 0 and length % 8 == 0 for at, length in layout)
    assert all(a + la == b for (a, la), (b, _) in zip(layout, layout[1:]))
    fm = ar_kernel.fm_layers(w["fm"], pcfg, fused)
    order = [(kind, blk, j)
             for blk in ar_kernel.fused_blocks(L, fused)
             for kind in ("tap", "fm") for j in range(len(blk))]

    def same(got, want):
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    for k in range(n):
        hr, cr = slice(k * Rn, (k + 1) * Rn), slice(k * Cn, (k + 1) * Cn)
        for (kind, blk, j), (at, length) in zip(order, layout):
            l = blk[j]
            if kind == "tap":
                assert length == -(-(2 * Rn + Cn) * G // 8) * 8
                taps = st[k, at:at + 2 * Rn * G].reshape(Rn, G, 2)
                for tap in (0, 1):
                    same(taps[:, :, tap], w["conv_w"][l, tap, hr])
                v0 = at + 2 * Rn * G
                same(st[k, v0:v0 + Cn * G].reshape(Cn, G),
                     w["cond_w"][l, cr])
            else:
                cols = S + R + (len(blk) - 1 - j) * G
                assert fm[l].shape[1] == cols
                same(st[k, at:at + Hn * cols].reshape(Hn, cols),
                     fm[l][k * Hn:(k + 1) * Hn])
        at = layout[-1][0]
        same(st[k, at:at + Sn * S].reshape(Sn, S),
             w["head1_w"][k * Sn:(k + 1) * Sn])
        same(st[k, at + Sn * S:at + Sn * (S + O)].reshape(Sn, O),
             w["head2_w"][k * Sn:(k + 1) * Sn])
    assert ar_kernel.Layout(fused=fused, cluster=n, resident=False).name \
        == f"ar_cluster[fused{fused},N{n},l2]"
    assert ar_kernel.Layout("bfloat16", fused, n).name == \
        f"ar_cluster[bf16,fused{fused},N{n}]"


def test_generate_cluster_fused_on_cpu_is_the_plain_version():
    """generate in a cluster=N, fused=W layout on a CPU tensor runs the
    plain version with split=N, whose matmuls ignore the split: the
    samples equal fused=W's without a cluster, exactly; weights made for
    another window or size are refused."""
    cfg, pp, c_up, noise, _ = _case("laplace")
    pcfg, ppp = port_cfg(cfg), port_pp(pp)
    c, u = torch.from_numpy(c_up), torch.from_numpy(noise)
    Layout = ar_kernel.Layout
    w = ar_kernel.kernel_weights(ppp, pcfg, Layout(fused=3, cluster=4),
                                 "cpu")
    assert "cluster_stages" in w.tensors and "fm" in w.tensors
    got = ar_kernel.generate(w, pcfg, c, noise=u, device="cpu")
    for want in (ar_kernel.generate(ppp, pcfg, c, noise=u, device="cpu",
                                    layout=Layout(fused=3)),
                 ar_kernel.generate_plain(ppp, pcfg, c, noise=u,
                                          device="cpu", fused=3, split=4)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for other in (Layout(fused=2, cluster=4), Layout(fused=3, cluster=2)):
        with pytest.raises(ValueError, match="kernel weights"):
            ar_kernel.generate(w, pcfg, c, noise=u, device="cpu",
                               layout=other)


def test_ladder_takes_the_fused_cluster_first(monkeypatch):
    """--fused W takes the cluster layout first within each dtype (on the
    CPU at the largest size that divides the widths), then ar_generate's
    fused layouts where no cluster fits the window, and raises where none
    fits. On a card the sizes and shared memory stand in for the kernels'
    own; the chooser skips a size whose fused block the kernel refuses."""
    Layout = ar_kernel.Layout
    c2 = get_config("shallow_laplace_single").model
    for W in (2, 4, 6):
        assert ar_kernel.choose_layout(c2, "auto", "cpu", fused=W) == \
            Layout(fused=W, cluster=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ar_kernel, "smem_limit", lambda dev: 2000)
    gen_bytes = [1000]
    monkeypatch.setattr(ar_kernel, "smem_bytes",
                        lambda cfg, lay: gen_bytes[0])
    sizes = {0: 8, 4: 16, 6: 0}
    asked = []

    def cluster(cfg, dtype, dev, fused, ns, wide=False):
        asked.append((dtype, fused, wide))
        return Layout(dtype, fused, sizes[fused]) if sizes[fused] else None

    monkeypatch.setattr(ar_kernel, "_cluster_layout", cluster)
    assert ar_kernel.choose_layout(c2, fused=4) == Layout(fused=4,
                                                          cluster=16)
    assert ar_kernel.choose_layout(c2) == Layout(cluster=8)
    # no cluster fits W = 6: ar_generate's fused layout, still fp32
    asked.clear()
    assert ar_kernel.choose_layout(c2, fused=6) == Layout(fused=6)
    assert asked == [("float32", 6, False)]
    gen_bytes[0] = 3000
    with pytest.raises(ValueError, match="fused=6"):
        ar_kernel.choose_layout(c2, fused=6)

    # on a card: a size whose fused block the kernel refuses is skipped,
    # the next that fits and fills the card is taken
    import types
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132,
                            shared_memory_per_block_optin=232448))

    def smem(cfg, lay):
        if lay.fused and lay.cluster == 16:
            raise ValueError("config not supported by the cluster AR "
                             "kernel: fused window")
        return 100000 if not lay.resident else 300000

    monkeypatch.setattr(ar_kernel, "cluster_smem_bytes", smem)
    monkeypatch.setattr(ar_kernel, "clusters_at_once",
                        lambda cfg, lay, dev=None:
                        {16: 7, 8: 15, 4: 30, 2: 66}[lay.cluster])
    assert ar_kernel.choose_layout(c2, "float32", fused=4) == Layout(
        fused=4, cluster=8, resident=False)
    assert ar_kernel.choose_layout(c2, "float32") == Layout(
        cluster=8, resident=False)


@pytest.mark.parametrize("fused", [3, 4])
def test_fused_session_on_the_cluster_equals_one_call(fused):
    """The fused streaming session takes the cluster size on the CPU too
    (the decode's), and its stream equals one call over its own
    conditioning and uniforms, exactly."""
    cfg, m, v, model, frames, hop = _stream_setup(
        "laplace", F=45, cond_channels=16, skip_channels=32)
    B = frames.shape[0]
    pcfg = port_cfg(cfg)
    syn = StreamingSynthesizer(extract_plain_params(model), model, pcfg,
                               hop_length=hop, batch=B, block_frames=32,
                               chunk=64, device="cpu", seed=5, fused=fused,
                               record_noise=True)
    assert syn.layout == ar_kernel.choose_layout(pcfg, "float32", "cpu",
                                                 fused)
    assert syn.layout.cluster > 1 and syn.weights.layout == syn.layout
    wav = _run(syn, frames, 9)
    one = ar_kernel.generate(syn.weights, pcfg, syn.cond_so_far(),
                             noise=syn.noise_so_far(),
                             device="cpu").numpy()
    np.testing.assert_array_equal(wav, one)
