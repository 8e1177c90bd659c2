"""The redesigned scoring and pooling kernels of the port, on the CPU.

``csrc/common.cuh::score_row`` (the row scoring of ``centroid_score.cu`` and
``fused_decode.cu``) scores a store row with eight lanes: lane s takes the
row's 16-byte chunks s, s + 8, ..., walks each in quads of 4 channels (an
INT8 / INT4 chunk's quads rotated by s / 2, an INT4 quad's high-nibble
channels after its low ones), sums with one fused multiply-add per channel
and group row, then adds the eight lane sums in a butterfly (xor 4, 2, 1)
and takes the max over the group.  ``csrc/pool_rank_keys.cu`` gives a rank
key D / 8 threads of 8 consecutive channels each; its mean is the f32 sum
over tokens in token order, its arkvale radius sums |k - center|^2 over
each thread's 8 channels, then over the key's threads in a butterfly.

The kernels run only on the card; here f32 models of those orders (written
below; a fused multiply-add is rounded once through float64) are held
against the JAX kernels in interpret mode: scores within ``SCORE_RTOL``
(1e-5) of their (sequence, head)'s largest |score|, rank keys within
``POOL_RTOL`` (1e-6) of their row's largest magnitude.  Identical rows at
different places of the store must score identically.  The pooling grid
(``block_centroid.pool_plan``, with the kernel's index arithmetic in
``pool_cover`` below) must cover every rank key's every channel group
exactly once, and the plain pooling must still match
JAX for every method.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import store as jstore
from repro.config import SparseConfig as JSparse
from repro.core.centroids import rank_query as j_rank_query
from repro.core.ragged import layout_for as j_layout_for
from repro.core.stacked import as_arrays as j_as_arrays
from repro.kernels import block_centroid as jbc
from repro.kernels import centroid_score as jcs

from repro_torch.core.quantization import decode_affine, unpack_split_half
from repro_torch.kernels import block_centroid as tbc
from repro_torch.kernels import centroid_score as tcs
from repro_torch.kernels import parity
from repro_torch.kernels.ref import store_row_head

B, S, PS, BUDGET = 2, 512, 16, 128
BLOCKS = (16, 64, 32)
QUANTS = ["none", "int8_asym", "int8_sym", "int4_asym", "int4_sym"]
METHODS = ("mean", "quest", "arkvale")


# -- the row scoring order ------------------------------------------------------


def lane_channels(Dp, bits):
    """Per lane of a row group (0..7), the channels it multiplies, in its
    order."""
    row_bytes = Dp * 4 if bits == 0 else Dp // 2 if bits == 4 else Dp
    n_chunks = row_bytes // 16
    order = []
    for s in range(8):
        chans = []
        for k in range(s, n_chunks, 8):
            if bits == 0:
                chans += range(4 * k, 4 * k + 4)
                continue
            for m in range(4):
                c = 16 * k + 4 * ((m + s // 2) % 4)
                chans += range(c, c + 4)
                if bits == 4:
                    chans += range(Dp // 2 + c, Dp // 2 + c + 4)
        order.append(chans)
    return order


def fmaf(a, b, c):
    """f32 fused multiply-add (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def score_row_model(rq, codes, scale, zero, tile_head, tile_rows, bits,
                    symmetric, n_kv):
    """Flat scores ``[B, rows]`` in ``score_row``'s order."""
    Bq, n_q, Dp = rq.shape
    head = store_row_head(tile_head, tile_rows, codes.shape[1])
    if bits == 0:
        x = codes.float()
    else:
        unpacked = unpack_split_half(codes) if bits == 4 else codes
        x = decode_affine(unpacked, scale[:, head], zero[:, head], bits, symmetric)
    r = rq.float().reshape(Bq, n_kv, n_q // n_kv, Dp)[:, head]   # [B, R, g, Dp]
    lanes = []
    for chans in lane_channels(Dp, bits):
        acc = torch.zeros(r.shape[:-1])
        for c in chans:
            acc = fmaf(x[:, :, None, c], r[..., c], acc)
        lanes.append(acc)
    t = [lanes[l] + lanes[l + 4] for l in range(4)]
    u = [t[0] + t[2], t[1] + t[3]]
    return (u[0] + u[1]).amax(-1)


def test_lane_channels_partition_every_channel():
    for Dp in (128, 256, 512):
        for bits in (0, 4, 8):
            order = lane_channels(Dp, bits)
            flat = sorted(c for chans in order for c in chans)
            assert flat == list(range(Dp)), (Dp, bits)


def _store_case(quant, D, g, seed):
    n_kv = len(BLOCKS)
    sparse = JSparse(token_budget=BUDGET, quant=quant)
    jla = j_as_arrays(j_layout_for(BLOCKS, S, PS, BUDGET))
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, n_kv, S // PS, PS, D)).astype(np.float32)
    q = rng.standard_normal((B, n_kv * g, D)).astype(np.float32)
    st = jstore.build_store_codes(jnp.asarray(k), jla, jnp.asarray(jla.row_offsets),
                                  sparse, quant)
    rq = j_rank_query(jnp.asarray(q), sparse.centroid_method, D)
    return jla, st, rq


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D,g", [(64, 1), (128, 3), (64, 8)],
                         ids=["Dp128-g1", "Dp256-g3", "Dp128-g8"])
def test_score_row_model_matches_jax(quant, D, g):
    jla, st, rq = _store_case(quant, D, g, seed=D + g)
    n_kv, tile_rows = len(BLOCKS), int(jla.tile_rows)
    if st.bits:
        want = jcs.centroid_scores_quantized(
            rq, st.codes, st.scale, st.zero, jla.tile_head, tile_rows,
            st.symmetric, st.bits, interpret=True)
    else:
        want = jcs.centroid_scores_f32(rq, st.codes, n_kv, jla.tile_head,
                                       tile_rows, interpret=True)
    want = torch.from_numpy(np.array(want))
    t = lambda a: torch.from_numpy(np.array(a))
    got = score_row_model(t(rq), t(st.codes), t(st.scale), t(st.zero),
                          t(jla.tile_head), tile_rows, st.bits, st.symmetric, n_kv)
    head = store_row_head(t(jla.tile_head), tile_rows, want.shape[1])
    for h in range(n_kv):
        rows = head == h
        top = want[:, rows].abs().amax(-1, keepdim=True)
        err = (got[:, rows] - want[:, rows]).abs()
        assert (err <= parity.SCORE_RTOL * top).all(), float((err / top).max())


@pytest.mark.parametrize("quant", ["none", "int8_sym", "int4_asym"])
def test_identical_rows_score_identically(quant):
    """Row 3 of head 0 copied over other rows of the head, in other 32-row
    runs (thread blocks of the staged kernel) and at other places of a warp
    (row % 4): the model, and the plain version, score every copy bitwise
    equally."""
    jla, st, rq = _store_case(quant, 128, 3, seed=7)
    n_kv, tile_rows = len(BLOCKS), int(jla.tile_rows)
    t = lambda a: torch.from_numpy(np.array(a))
    codes = t(st.codes)
    head = store_row_head(t(jla.tile_head), tile_rows, codes.shape[1])
    same = torch.nonzero(head == 0).flatten()
    copies = same[[3, 4, 6, 21, 64, 127]]
    codes[:, copies] = codes[:, 3:4]
    args = (t(rq), codes, t(st.scale), t(st.zero), t(jla.tile_head), tile_rows)
    for scores in (score_row_model(*args, st.bits, st.symmetric, n_kv),
                   tcs.centroid_scores_plain(*args, bits=st.bits,
                                             symmetric=st.symmetric, n_kv=n_kv)):
        s = scores[:, copies]
        assert torch.equal(s, s[:, :1].expand_as(s))


# -- the pooling grid ---------------------------------------------------------------


def pool_cover(plan):
    """Per (thread block, thread) of ``plan``'s grid, the rank key it pools
    and its first channel, -1 for a thread without one: two int arrays
    ``[grid, NT]``, from ``pool_rank_keys.cu``'s index arithmetic (slot =
    thread / lanes, key = block * keys_per_cta + slot, first channel =
    (thread % lanes) * 8)."""
    lanes, per_cta = plan["lanes"], plan["keys_per_cta"]
    t = np.arange(tbc.NT)[None, :]
    slot, sub = t // lanes, t % lanes
    key = np.arange(plan["grid"])[:, None] * per_cta + slot
    own = (slot < per_cta) & (key < plan["n_keys"])
    return np.where(own, key, -1), np.where(own, sub * tbc.VEC, -1)


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("D", [64, 128])
def test_pool_plan_covers_every_key_once(D, bs):
    """3 rows of 13 rank keys each: 39 keys, not a multiple of a thread
    block's run; every (key, channel group) pooled by exactly one thread."""
    plan = tbc.pool_plan(3, 13 * bs, D, bs)
    assert plan["n_keys"] == 39 and plan["lanes"] * plan["keys_per_cta"] == tbc.NT
    assert plan["n_keys"] % plan["keys_per_cta"]
    key, c0 = pool_cover(plan)
    assert key.shape == (plan["grid"], tbc.NT)
    own = key >= 0
    pairs = key[own] * D + c0[own]
    assert np.array_equal(np.sort(pairs), np.arange(0, 39 * D, tbc.VEC))
    # a rank key's threads are neighbours within one aligned run of lanes
    lanes = plan["lanes"]
    for k in range(39):
        cta, thr = np.nonzero(key == k)
        assert len(set(cta)) == 1 and thr.min() % lanes == 0
        assert np.array_equal(thr, thr.min() + np.arange(lanes))
    # idle threads only in the last thread block
    assert own[:-1].all()


@pytest.mark.parametrize("D", [4, 96, 512])
def test_pool_plan_rejects_head_dims_the_kernel_cannot_cut(D):
    with pytest.raises(ValueError, match="head_dim"):
        tbc.pool_plan(1, 64, D, 16)


# -- the pooled rank keys -------------------------------------------------------------


def _bf16_keys(D, seed):
    """bf16-representable f32 keys [2, 3, S, D]."""
    x = np.random.default_rng(seed).standard_normal((2, 3, S, D)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("bs", [16, 32, 64])
@pytest.mark.parametrize("method", METHODS)
def test_pool_rank_keys_plain_matches_jax_on_bf16_keys(method, bs):
    """The plain pooling of bf16 keys (head_dim 128, the serving cache's
    type) against JAX's kernel in interpret mode on the same values."""
    keys = _bf16_keys(128, seed=bs)
    calls = tbc.plain_calls
    got = tbc.pool_rank_keys(keys, bs, method)
    assert tbc.plain_calls == calls + 1
    want = torch.from_numpy(np.array(jbc.pool_rank_keys(
        jnp.asarray(keys.float().numpy()), bs, method, chunk=128, interpret=True)))
    parity.check_pool(got, want, method, "plain vs JAX")


def pool_model(keys, bs, method):
    """The kernel's mean (token-order f32 sum / bs) or arkvale radius
    (fused multiply-adds over a thread's 8 channels, then a butterfly over
    the key's D / 8 threads, max over tokens) -> ``[..., S / bs, D]`` mean
    or ``[..., S / bs]`` radius."""
    *lead, Sq, D = keys.shape
    x = keys.float().reshape(*lead, Sq // bs, bs, D)
    if method == "mean":
        acc = x[..., 0, :]
        for t in range(1, bs):
            acc = acc + x[..., t, :]
        return acc / bs
    center = 0.5 * (x.amax(-2) + x.amin(-2))
    d = x - center[..., None, :]
    part = torch.zeros(d.shape[:-1] + (D // 8,))
    for c in range(8):
        part = fmaf(d[..., c::8], d[..., c::8], part)
    L = D // 8
    off = L // 2
    while off:
        part = part + part[..., torch.arange(L) ^ off]
        off //= 2
    return part[..., 0].amax(-1).sqrt()


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("method", ["mean", "arkvale"])
def test_pool_model_matches_jax(method, D, bs):
    """The kernel's summation orders for mean and arkvale, against JAX's
    kernel within ``POOL_RTOL`` of the rank key's largest magnitude."""
    keys = _bf16_keys(D, seed=D + bs)
    want = torch.from_numpy(np.array(jbc.pool_rank_keys(
        jnp.asarray(keys.float().numpy()), bs, method, chunk=128, interpret=True)))
    got = tbc.pool_rank_keys_plain(keys, bs, method).clone()
    model = pool_model(keys, bs, method)
    if method == "mean":
        got[..., :D] = model
    else:
        got[..., D] = model
    parity.check_pool(got, want, method, "kernel-order model vs JAX")
