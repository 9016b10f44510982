"""The attention kernels' launch plans and wide heads against the JAX package
on the CPU: ``flash_attention`` and ``ops.flash_mha`` at head widths past
128 (gemma-7b's 256, and 320) against the Pallas kernel in interpret mode
and JAX's ``flash_mha``; the flash kernel's split of the output features
over CTAs (``flash_plan``); ``paged_plan`` / ``paged_split`` (how the paged
decode kernel splits a row's pages over a cluster) at the shapes
``chip_smoke.py`` runs; and a plain emulation of that split with the
kernel's roundings and merges against JAX's ``paged_attn_ref``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_cpu  # noqa: E402,F401  (this worker's share of the cores)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

# flash as tests/test_flash_attention.py (f32 2e-5, bf16 2e-2)
FLASH_TOL = {np.float32: 2e-5, "bf16": 2e-2}
# paged decode: f32 as tests/test_kv.py; bf16 against one fp32 softmax that
# rounds neither q * scale nor p (chip_smoke.py's PAGED_*)
PAGED_F32_TOL = 2e-5
PAGED_BF16_REL = 2.0 ** -6
H100_SMS = 132
SERVE_MAX_LEN = 256          # chip_smoke.py: the table width is this / page


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _jdt(dtype):
    return jnp.float32 if dtype is np.float32 else jnp.bfloat16


def _tdt(dtype):
    return torch.float32 if dtype is np.float32 else torch.bfloat16


# ---------------------------------------------------------------------------
# flash attention past D = 128
# ---------------------------------------------------------------------------

# (H, S, D, blk, causal): Sk a multiple of the block when not causal
WIDE = [(2, 64, 256, 32, True), (1, 64, 256, 64, False),
        (2, 48, 320, 16, True), (1, 64, 320, 32, False)]


@pytest.mark.parametrize("h,s,d,blk,causal", WIDE)
@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_wide_flash_matches_jax_kernel(h, s, d, blk, causal, dtype):
    rng = np.random.default_rng(d + s)
    q, k, v = (rng.normal(size=(h, s, d)).astype(np.float32)
               for _ in range(3))
    want = jflash(*(jnp.asarray(a, _jdt(dtype)) for a in (q, k, v)),
                  causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    got = tfa.flash_attention(*(_t(a, _tdt(dtype)) for a in (q, k, v)),
                              causal=causal, blk_q=blk, blk_k=blk)
    assert got.dtype == _tdt(dtype) and got.shape == (h, s, d)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("d", [256, 320])
@pytest.mark.parametrize("heads", [(4, 2), (2, 2)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
def test_wide_flash_mha_matches_jax(d, heads, causal):
    h, kh = heads
    rng = np.random.default_rng(d + h)
    b, s = 2, 32
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kh, d)).astype(np.float32)
            for _ in range(2))
    want = jops.flash_mha(*map(jnp.asarray, (q, k, v)), causal=causal,
                          use_pallas=True, blk=16)
    got = tops.flash_mha(*map(_t, (q, k, v)), causal=causal, blk=16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=FLASH_TOL[np.float32],
                               rtol=FLASH_TOL[np.float32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_plan_covers_every_feature_once(dtype):
    for d in range(1, 700):
        plan = tfa.flash_plan(d, dtype)
        chunk, splits = plan["chunk"], plan["splits"]
        assert plan["route"] == ("tc" if dtype == torch.bfloat16 else "cc")
        assert 0 < chunk <= tfa.CHUNK
        # chunk c owns [c * chunk, min((c + 1) * chunk, d)): together every
        # feature once, and no chunk empty
        owned = np.zeros(d, int)
        for c in range(splits):
            lo, hi = c * chunk, min((c + 1) * chunk, d)
            assert lo < hi
            owned[lo:hi] += 1
        assert (owned == 1).all()
        if dtype == torch.bfloat16:
            # multiples of 16 (the MMA's k), whole up to 128
            assert chunk % 16 == 0 and (splits == 1) == (d <= 128)
    assert tfa.flash_plan(256, torch.bfloat16)["splits"] == 2   # gemma-7b
    assert tfa.flash_plan(80, torch.bfloat16)["chunk"] == 80    # zamba2


# ---------------------------------------------------------------------------
# paged decode: the split over a cluster
# ---------------------------------------------------------------------------

def _smoke_shapes():
    """(B, KH, G, D, page, W, kv_len) of chip_smoke.py's paged cases at
    qwen2-72b's heads (64 / 8, d_head 128): ctx144 and the ragged rows with
    a parked one at pages 8 and 16, and 4096 keys a row at page 16."""
    out = []
    for page in (8, 16):
        w = SERVE_MAX_LEN // page
        out.append((4, 8, 8, 128, page, w, [144] * 4))
        out.append((4, 8, 8, 128, page, w, [17, 80, 200, w * page + 1]))
    out.append((4, 8, 8, 128, 16, 256, [4096] * 4))
    return out


def _check_cover(kv_len, w, page, splits):
    ranges = tpa.paged_split(kv_len, w, page, splits)
    assert len(ranges) == splits
    nkeys = min(kv_len, w * page)
    seen = np.zeros(max(nkeys, 1), int)
    for beg, end in ranges:
        assert beg <= end
        if end > beg:
            # whole pages from a page boundary, no key at or past kv_len,
            # no page at or past column W
            assert 0 <= beg and end <= nkeys
            assert beg % page == 0 and -(-end // page) <= w
            seen[beg:end] += 1
    assert (seen[:nkeys] == 1).all()
    # every live page of the row in exactly one split
    pages = np.zeros(-(-nkeys // page), int)
    for beg, end in ranges:
        if end > beg:
            pages[beg // page:-(-end // page)] += 1
    assert (pages == 1).all()


@pytest.mark.parametrize("shape", _smoke_shapes(),
                         ids=lambda s: "page%d-W%d-%s" % (s[4], s[5], s[6][1]))
def test_paged_plan_fills_one_wave_and_covers_every_page(shape):
    bsz, kh, g, d, page, w, lens = shape
    # the wrapper plans from the table's width when kv_len is on the card
    plan = tpa.paged_plan(bsz, kh, w, page, w * page, H100_SMS, groups=g, d=d)
    assert 1 <= plan["splits"] <= tpa.MAX_SPLITS
    assert plan["ctas"] <= H100_SMS
    assert plan["ctas"] == bsz * kh * plan["splits"]
    # only the last split of a full table holds less than one 64-key tile
    assert (plan["splits"] - 1) * -(-tpa.TILE // page) < w
    for n in lens:
        _check_cover(n, w, page, plan["splits"])


def test_paged_plan_splits_long_rows_and_keeps_short_ones_whole():
    # 4096 keys at page 16: 4 splits of 64 pages fill 128 of 132 SMs
    plan = tpa.paged_plan(4, 8, 256, 16, 4096, H100_SMS)
    assert plan["splits"] == 4 and plan["ctas"] == 128
    assert tpa.paged_split(4096, 256, 16, 4) == [
        (0, 1024), (1024, 2048), (2048, 3072), (3072, 4096)]
    # one tile's worth of keys: one split; a host-known length plans from it
    assert tpa.paged_plan(4, 8, 32, 8, 60, H100_SMS)["splits"] == 1
    assert tpa.paged_plan(4, 8, 32, 8, 144, H100_SMS)["splits"] == 3
    # a wide batch fills the card alone
    assert tpa.paged_plan(32, 8, 32, 8, 256, H100_SMS)["splits"] == 1
    # GQA groups past 8 and D past 256 take more CTAs a row
    plan = tpa.paged_plan(1, 2, 64, 8, 512, H100_SMS, groups=12, d=320)
    assert (plan["head_tiles"], plan["feature_chunks"]) == (2, 2)
    assert plan["ctas"] == 8 * plan["splits"] <= H100_SMS
    # every length and every split count covers each live page once
    for w, page in ((5, 8), (18, 8), (9, 16), (7, 48), (12, 3)):
        for splits in range(1, tpa.MAX_SPLITS + 1):
            for n in list(range(0, w * page + 3)):
                _check_cover(n, w, page, splits)


def _round(x, dtype):
    return x.to(dtype).to(torch.float32)


def emulate_paged(q, kp, vp, table, kv_len, splits, scale=0.0):
    """The kernel's arithmetic in plain torch: per row and split (the
    ``paged_split`` ranges), 64-key tiles of which each of 4 warps takes 16
    keys with its own online softmax (q * scale and p rounded to q's dtype,
    l summing the unrounded p), then the warps' and the splits' (m, l, acc)
    merged against their common max, l floored at 1e-30."""
    bsz, h, d = q.shape
    _, page, kh, _ = kp.shape
    g = h // kh
    w = table.shape[1]
    scale = scale or 1.0 / d ** 0.5
    dt = q.dtype
    qs = _round(q.float() * scale, dt).reshape(bsz, kh, g, d)
    out = torch.empty((bsz, kh, g, d))
    for row in range(bsz):
        states = []                          # (m (K, G), l, acc (K, G, D))
        for beg, end in tpa.paged_split(int(kv_len[row]), w, page, splits):
            for warp in range(4):
                m = torch.full((kh, g), -1e30)
                l = torch.zeros((kh, g))
                acc = torch.zeros((kh, g, d))
                for t0 in range(beg, end, tpa.TILE):
                    k0, k1 = t0 + 16 * warp, min(t0 + 16 * warp + 16, end)
                    if k0 >= k1:
                        continue
                    keys = torch.arange(k0, k1)
                    pid = table[row, keys // page].long()
                    kk = kp[pid, keys % page].float()          # (n, K, D)
                    vv = vp[pid, keys % page].float()
                    s = torch.einsum("kgd,nkd->kgn", qs[row], kk)
                    mn = torch.maximum(m, s.max(-1).values)
                    corr = torch.exp(m - mn)
                    p = torch.exp(s - mn[..., None])
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "kgn,nkd->kgd", _round(p, dt), vv)
                    m = mn
                states.append((m, l, acc))
        big_m = torch.stack([s[0] for s in states]).max(0).values
        lsum = sum(s[1] * torch.exp(s[0] - big_m) for s in states)
        asum = sum(s[2] * torch.exp(s[0] - big_m)[..., None] for s in states)
        out[row] = asum / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(bsz, h, d).to(dt)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"], ids=["f32", "bf16"])
def test_split_and_merge_emulation_matches_jax_oracle(dtype):
    """Rows of 160 keys (all splits busy), 70 (the last split empty), 5
    (shorter than one split: the others empty), 1, and a parked row (its
    table all the garbage page, kv_len past W * page), at page 4 with the
    splits a small card gives."""
    bsz, h, kh, d, page, w = 5, 8, 2, 32, 4, 40
    rng = np.random.default_rng(7)
    npages = bsz * w + 1
    q = rng.normal(size=(bsz, h, d)).astype(np.float32)
    kp, vp = (rng.normal(size=(npages, page, kh, d)).astype(np.float32)
              for _ in range(2))
    table = (np.arange(bsz * w).reshape(bsz, w) + 1).astype(np.int32)
    table[4] = 0
    kv_len = np.array([160, 70, 5, 1, w * page + 1], np.int32)
    plan = tpa.paged_plan(bsz, kh, w, page, w * page, 40, groups=h // kh,
                          d=d)
    splits = plan["splits"]
    assert splits == 3
    spans = [tpa.paged_split(n, w, page, splits) for n in kv_len]
    assert spans[1][2][0] == spans[1][2][1]          # 70 keys: split 3 empty
    assert sum(e > b for b, e in spans[2]) == 1      # 5 keys: one split
    tdt = _tdt(dtype)
    got = emulate_paged(_t(q, tdt), _t(kp, tdt), _t(vp, tdt),
                        torch.from_numpy(table), torch.from_numpy(kv_len),
                        splits)
    jdt = _jdt(dtype)
    want = np.asarray(jref.paged_attn_ref(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(table), jnp.asarray(kv_len)), np.float32)
    err = np.abs(np.asarray(got.float()) - want).max()
    if dtype is np.float32:
        assert err <= PAGED_F32_TOL * max(1.0, np.abs(want).max())
    else:
        assert err <= PAGED_BF16_REL * np.abs(want).max()
    # and the port's plain version (what the kernel is held to on the card)
    plain = tpa.paged_decode_plain(_t(q, tdt), _t(kp, tdt), _t(vp, tdt),
                                   torch.from_numpy(table),
                                   torch.from_numpy(kv_len))
    np.testing.assert_allclose(np.asarray(plain.float()), want, atol=2e-5,
                               rtol=2e-5)
