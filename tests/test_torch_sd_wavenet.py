"""The speaker-dependent WaveNet vocoder (Tamamori et al., Interspeech 2017;
the benchmark's `tamamori_sd_arctic` configuration: 30 layers, R 512,
G 1024, S 256, C 32, a 256-class mu-law softmax, hop 80) on the port's
decode path, on the CPU with seeded random weights: its configuration file,
the decode against the benchmark's plain reference (`port_bench.reference`,
which imports nothing of the port) at narrowed widths, the plain version
in the cluster kernel's order, the layout ladder's place for the cluster
kernel's wide form, and the yardstick's off-chip term.

The decode's check reads the softmax head's CDF gap (`reference.cdf_gaps`):
0 where the uniform falls in the program's class's interval of the
reference's fp32 CDF, the CDF's rounding where a class flips at a bin edge,
and on the scale of a class's probability for a wrong class. The program
and the reference differ here only in the order of fp32 sums (the
upsampler rounds its products to bf16 in both), so LIMIT holds the former
and no wrong class passes it."""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from port_bench import harness, inputs, reference, yardstick
from port_bench.generators.offline import load_model
from shallow_wavenet_tpu_torch.bin import decode, sass_diff
from shallow_wavenet_tpu_torch.config import Config, feature_dim
from shallow_wavenet_tpu_torch.data.dataset import Utterance
from shallow_wavenet_tpu_torch.models.wavenet import extract_plain_params
from shallow_wavenet_tpu_torch.ops import ar_kernel

CONFIG = harness.load_json(harness.ROOT, "configs", "tamamori_sd_arctic")
# the CDF gap the port may read: fp32 rounding of the CDF at a bin edge
# (about 1e-7 for 256 classes), well below a wrong class's probability
LIMIT = 1e-5
SEED = 2 ** 31 + 19


def narrow_tree() -> dict:
    """The configuration's tree at the published depth, dilations, classes,
    conditioning and hop, with R, G and S narrowed to 32, 64 and 32."""
    tree = json.loads(json.dumps(CONFIG["config"]))
    tree["model"].update(residual_channels=32, gate_channels=64,
                         skip_channels=32)
    return tree


@pytest.fixture(scope="module")
def narrow():
    tree = narrow_tree()
    cfg = Config.from_dict(tree)
    w = inputs.weights(tree["model"], SEED, "cpu")
    return cfg, tree["model"], w, load_model(cfg, w, "cpu")


def test_the_configuration_reads_back_unchanged():
    tree = CONFIG["config"]
    cfg = Config.from_dict(tree)
    assert json.loads(json.dumps(cfg.to_dict())) == tree
    m = cfg.model
    assert feature_dim(cfg) == m.aux_channels == 28
    assert m.dilations == tuple(2 ** i for _ in range(3) for i in range(10))
    assert (m.residual_channels, m.gate_channels, m.skip_channels,
            m.cond_channels, m.head, m.quantize_channels) == (
        512, 1024, 256, 32, "softmax", 256)
    assert int(np.prod(m.upsample_factors)) == cfg.data.hop_length == 80
    assert cfg.data.sample_rate == 16000
    assert CONFIG["reduced"] == ["weights", "corpus"]
    # the cluster kernel's 16-way split divides every width
    assert ar_kernel.cluster_sizes(m)[0] == 16
    part = ar_kernel.cluster_partition(m, 16)
    assert [len(part[k][0]) for k in ("h", "cond", "z", "skip")] == [
        32, 2, 32, 16]


def test_decode_batch_against_the_reference(narrow):
    """Two rows of unequal length through the decode CLI's decode_batch on
    the CPU (the plain version, at the layout's cluster size), each
    teacher-forced through the reference on its own classes and
    uniforms."""
    cfg, mc, w, model = narrow
    hop = cfg.data.hop_length
    rng = np.random.default_rng(SEED)
    frames = (3, 5)
    utts = [Utterance(np.zeros(0, np.float32), rng.standard_normal(
        (f, mc["aux_channels"])).astype(np.float32)) for f in frames]
    noise = ar_kernel.uniform_noise(
        (2, max(frames) * hop), torch.Generator().manual_seed(SEED))
    layout = decode.kernel_layout(cfg.model, "float32", "cpu")
    assert layout["cluster"] == 16
    wavs = decode.decode_batch(model, cfg, utts, noise=noise, layout=layout,
                               device="cpu")
    assert [len(x) for x in wavs] == [f * hop for f in frames]
    padded = torch.from_numpy(np.stack([
        np.pad(u.feats, ((0, max(frames) - u.feats.shape[0]), (0, 0)))
        for u in utts]))
    c_up = reference.upsample(w, mc, padded)
    for r, wav in enumerate(wavs):
        n = len(wav)
        gaps = reference.cdf_gaps(w, mc, c_up[r, :n], noise[r, :n],
                                  torch.from_numpy(wav))
        assert float(gaps.max()) <= LIMIT


def test_the_plain_version_in_the_wide_forms_order(narrow):
    """generate_plain summing in the order of the cluster kernel at N = 16
    (`split=16, chain=True`), which its wide form shares: each dot as 16
    chains over the ranks' slices (`cluster_partition`), then the ranks'
    partials in rank order; against the reference on its own classes. On
    the CPU `wide` changes nothing."""
    cfg, mc, w, model = narrow
    T = 96
    g = torch.Generator().manual_seed(SEED + 1)
    c_up = torch.randn((1, T, mc["cond_channels"]), generator=g)
    noise = ar_kernel.uniform_noise((1, T), g)
    pp = extract_plain_params(model)
    out = ar_kernel.generate_plain(pp, cfg.model, c_up, noise=noise,
                                   split=16, chain=True, device="cpu")
    gaps = reference.cdf_gaps(w, mc, c_up[0], noise[0], out[0])
    assert float(gaps.max()) <= LIMIT
    short = slice(0, 48)
    kw = dict(noise=noise[:, short], cluster=16, device="cpu")
    assert torch.equal(
        ar_kernel.generate(pp, cfg.model, c_up[:, short], wide=True, **kw),
        ar_kernel.generate(pp, cfg.model, c_up[:, short], **kw))


def test_the_off_chip_term_at_the_published_widths():
    """Each step after the first reads the 56,578,048 bytes of fp32 weights
    beyond the card's on-chip storage (178,212,864 - 121,634,816) again."""
    mc = CONFIG["config"]["model"]
    assert 4 * yardstick.ar_weight_count(mc) == 178_212_864

    def nbytes(n):
        ms, by = yardstick.ar_bound_ms(mc, 1, n, lengths=[n])
        assert by == "bytes"
        return ms * 1e-3 * yardstick.PEAK_BYTES

    step = nbytes(3) - nbytes(2) - 4.0 * (mc["cond_channels"] + 2)
    assert round(step) == 56_578_048


WIDE_LAYOUT = {"dtype": "float32", "stream": False, "chunk": 64, "fused": 0,
               "cluster": 16, "wide": True}


def test_the_wide_form_is_the_ladders_last_fp32_layout(monkeypatch):
    """The wide form comes after every other fp32 layout, so a model that
    one of them fits keeps it, and before every bf16 one, so "auto" keeps
    fp32 wherever the wide form fits; on a card (sizes stand in for the
    kernels' own) it is taken where no other fp32 layout fits, even where
    a bf16 one does, unfused only (decode_layout drops --fused for it);
    on the CPU the plain version needs no such form."""
    dtypes = [lay[0] for lay in decode.KERNEL_LAYOUTS]
    wide_at = [lay[3] for lay in decode.KERNEL_LAYOUTS].index(decode.WIDE)
    assert decode.KERNEL_LAYOUTS[wide_at] == ("float32", False, 64,
                                              decode.WIDE)
    assert dtypes[:wide_at + 1] == ["float32"] * (wide_at + 1)
    assert "float32" not in dtypes[wide_at + 1:]
    assert [lay[3] for lay in decode.KERNEL_LAYOUTS].count(decode.WIDE) == 1
    sd = Config.from_dict(CONFIG["config"]).model
    assert decode.kernel_layout(sd, "float32", "cpu") == {
        "dtype": "float32", "stream": False, "chunk": 64, "fused": 0,
        "cluster": 16}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ar_kernel, "smem_limit", lambda dev: 232448)
    # one SM per row: bf16 fits, fp32 does not (as on an H100 here)
    monkeypatch.setattr(
        ar_kernel, "smem_bytes", lambda cfg, dtype, stream, chunk, fused:
        10 ** 6 if dtype == "float32" else 10 ** 5)
    other = [0]

    def size(cfg, dtype, dev, fused=0, wide=False):
        return 16 if wide else other[0]

    monkeypatch.setattr(ar_kernel, "cluster_size", size)
    assert decode.kernel_layout(sd, "float32") == WIDE_LAYOUT
    assert decode.kernel_layout(sd, "auto") == WIDE_LAYOUT
    assert decode.decode_layout(sd) == WIDE_LAYOUT
    assert decode.kernel_layout(sd, "bfloat16") == {
        "dtype": "bfloat16", "stream": False, "chunk": 64, "fused": 0,
        "cluster": 0}
    with pytest.raises(decode.NoLayoutError):
        decode.kernel_layout(sd, "float32", fused=4)
    assert decode.decode_layout(sd, "float32", fused=4) == WIDE_LAYOUT
    with pytest.raises(decode.NoLayoutError):
        decode.kernel_layout(sd, "float32", cluster=False)
    other[0] = 8
    assert decode.kernel_layout(sd, "float32") == {
        "dtype": "float32", "stream": False, "chunk": 64, "fused": 0,
        "cluster": 8}


def test_the_wide_form_takes_the_largest_size_that_fits(monkeypatch):
    """Each SM of the wide form streams 1/N of the weights every step, so
    its size is the largest that fits, though 7 clusters of 16 cover less
    of the card than 15 of 8; a size whose block does not fit, or that the
    form refuses, is skipped (bytes and occupancy stand in for the
    kernel's own)."""
    sd = Config.from_dict(CONFIG["config"]).model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(ar_kernel, "smem_limit", lambda dev: 232448)
    smem = {16: 198900, 8: 300000, 4: 200000, 2: 200000}

    def smem_bytes(cfg, dtype, n, res, fused=0, wide=False):
        assert wide and not res
        return smem[n]

    monkeypatch.setattr(ar_kernel, "cluster_smem_bytes", smem_bytes)
    monkeypatch.setattr(ar_kernel, "max_active_clusters",
                        lambda cfg, dtype, n, res, dev, fused=0, wide=False:
                        {16: 7, 8: 15, 4: 30, 2: 60}[n])
    assert ar_kernel.cluster_size(sd, "float32", wide=True) == 16
    smem[16] = 300000
    assert ar_kernel.cluster_size(sd, "float32", wide=True) == 4


def test_the_wide_forms_names():
    assert ar_kernel.variant("float32", False, 0, 16, False,
                             wide=True) == "ar_cluster[N16,wide]"
    assert ar_kernel.variant("float32", False, 0, 16, False) \
        == "ar_cluster[N16,l2]"
    # every ring row in shared memory but in the wide form
    sd = Config.from_dict(CONFIG["config"]).model
    assert ar_kernel.cluster_rings(sd, 16, "float32") == (3069, 0)
    # sass_diff matches a production instance with the wide form's
    # template argument (off) to the parent's, and tells the wide one apart
    old = ("_ZN53_GLOBAL__N__962581f1_20_ar_cluster_parent_cu_77f3002a17ar_"
           "cluster_kernelIfLb0ELb0ELi0ELb0EEEvNS_6ParamsE")
    new = old.replace("Li0ELb0E", "Li0ELb0ELb0E")
    wide = old.replace("Li0ELb0E", "Li0ELb0ELb1E")
    assert sass_diff._key(new) == sass_diff._key(old)
    assert sass_diff._key(wide) != sass_diff._key(old)
