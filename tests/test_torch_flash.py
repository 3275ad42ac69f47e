"""The port's flash-attention wrapper against the reference's Pallas one.

On the CPU the wrapper takes its plain PyTorch version, so these tests
hold the port's arithmetic, layouts, GQA head mapping, masks and errors
against the reference's ``kernels/flash_attention.py`` run the way the
reference's own tests run it (Pallas in interpret mode).  The same
numpy inputs go to both.  The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_bhsd as ref_bhsd
from repro.kernels.ref import flash_attention_ref as ref_oracle
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bhsd)
from repro_torch.kernels.ref import flash_attention_ref
from torch_launch import cpu_launch, fake_entry  # noqa: F401

torch.set_num_threads(1)

# test_kernels.py's FLASH_CASES: (B, Sq, Sk, H, Hkv, D, causal)
FLASH_CASES = [
    (2, 256, 256, 4, 4, 64, True),     # MHA causal, aligned
    (1, 200, 200, 4, 2, 32, True),     # GQA, ragged (padding path)
    (2, 128, 384, 8, 2, 64, False),    # cross-attn shape, GQA 4x
    (1, 130, 130, 2, 1, 16, True),     # MQA, tiny head dim
    (1, 64, 64, 1, 1, 128, True),      # single head, single block
]


def _qkv(rng, b, sq, sk, h, hkv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", FLASH_CASES)
def test_flash_attention_vs_reference_pallas(B, Sq, Sk, H, Hkv, D, causal):
    """Twin of test_flash_attention_vs_oracle, f32 at 2e-5."""
    q, k, v = _qkv(np.random.default_rng(B * 31 + Sq), B, Sq, Sk, H, Hkv, D)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64, interpret=True))
    got = flash_attention(*_t(q, k, v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    """Twin of test_flash_attention_bf16: bf16 in and out, 5e-2."""
    q, k, v = _qkv(np.random.default_rng(5), 1, 128, 128, 4, 4, 64)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ref_flash(bf(q), bf(k), bf(v), causal=True,
                                block_q=64, block_k=64, interpret=True),
                      np.float32)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


# head dim 80 (Zamba2-2.7B's shared block, 2560 / 32) and non-causal
# D 64 (SeamlessM4T's encoder), Sq = Sk and Sq != Sk
D80_CASES = [(1, 96, 96, 4, 4, 80, True), (2, 70, 70, 4, 2, 80, False),
             (1, 40, 100, 4, 2, 80, True), (1, 100, 40, 2, 1, 80, False),
             (1, 130, 130, 4, 4, 64, False)]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal", D80_CASES)
def test_head_dim_80_and_full_attention_vs_reference_pallas(B, Sq, Sk, H,
                                                             Hkv, D, causal):
    """The reference's Pallas kernel takes D as a full block dimension,
    so it computes D 80; the port's plain version agrees (f32, 2e-5),
    and the launch count keys these calls by head dim and mask."""
    q, k, v = _qkv(np.random.default_rng(D * 7 + Sq + Sk), B, Sq, Sk, H,
                   Hkv, D)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64, interpret=True))
    got = flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ref_flash(bf(q), bf(k), bf(v), causal=causal,
                                block_q=64, block_k=64, interpret=True),
                      np.float32)
    got = flash_attention(*_t(q, k, v, dtype=torch.bfloat16), causal=causal)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)
    assert kfa.shape_key(D, causal) == f"d{D},{'causal' if causal else 'full'}"


def test_launches_by_shape_count_each_key(cpu_launch, monkeypatch):
    """The operator's launch (on CPU operands through a stand-in entry)
    tags each launch with its shape key, and with "staged" where an
    operand was staged; the ledger's tag query counts each key."""
    entry = fake_entry("flash_attention_fwd")
    monkeypatch.setattr(kfa, "_entry", lambda: entry)

    def launch(dtype, d, causal, sq=16):
        q = torch.zeros((1, sq, 2, d), dtype=dtype)
        kv = torch.zeros((1, 16, 2, d), dtype=dtype)
        o = torch.empty_like(q)
        torch.ops.repro_torch.flash_attention_fwd(q, kv, kv, o, causal, 0.5)

    launch(torch.bfloat16, 80, True)
    launch(torch.bfloat16, 64, False)
    launch(torch.float16, 64, False)
    launch(torch.float32, 16, True)
    q = torch.zeros((1, 16, 2, 65), dtype=torch.bfloat16)[..., :64]
    kv = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    torch.ops.repro_torch.flash_attention_fwd(q, kv, kv, torch.empty_like(
        kv), False, 0.5)  # q's head stride 65: off 16 bytes, staged
    assert build.launches("flash", tag=kfa.shape_key(80, True)) == 1
    assert build.launches("flash", tag="d64,full") == 3
    assert build.launches("flash", tag="d16,causal") == 1
    assert build.launches("flash", tag="staged") == 1
    assert build.launches("flash", dtype="bfloat16", tag="staged") == 1
    assert build.launches("flash", path="mma") == 4
    assert build.launches("flash", path="simt", dtype="float32") == 1
    assert build.launches("flash") == len(entry.calls) == 5


def test_flash_attention_block_shape_independence():
    """Twin of test_flash_attention_block_shape_independence (1e-5): the
    port's answer (its k-block is fixed) is the reference's at every
    block shape the reference's test runs."""
    q, k, v = _qkv(np.random.default_rng(6), 1, 192, 192, 2, 2, 32)
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    for bq, bk in [(64, 64), (64, 128), (192, 64)]:
        want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, block_q=bq,
                                    block_k=bk, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk", [(40, 100), (100, 40)])
def test_causal_mask_is_top_left_aligned(sq, sk):
    """With Sq != Sk the causal mask keeps kpos <= qpos (top-left), as the
    reference's kernel and oracle do — not the bottom-right alignment of
    a decode-style mask."""
    q, k, v = _qkv(np.random.default_rng(sq + sk), 1, sq, sk, 2, 1, 16)
    want = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True))
    got = flash_attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # row 0 sees key 0 only: its output is v[0] exactly
    np.testing.assert_allclose(got[0, 0].numpy(),
                               np.repeat(v[0, 0], 2, axis=0),
                               rtol=1e-6, atol=1e-6)


def test_bhsd_layout_maps_heads_like_the_reference():
    """flash_attention_bhsd: q (BH, Sq, D), k/v (BHkv, Sk, D); row b reads
    kv row b // (BH / BHkv).  Against the reference's bhsd kernel, and
    against attending to the mapped kv row alone."""
    rng = np.random.default_rng(11)
    bh, bhkv, s, d = 6, 2, 70, 32
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    v = rng.standard_normal((bhkv, s, d)).astype(np.float32)
    want = np.asarray(ref_bhsd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, block_q=64,
                               block_k=64, interpret=True))
    got = flash_attention_bhsd(*_t(q, k, v), causal=True)
    assert tuple(got.shape) == (bh, s, d) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    tq, tk, tv = _t(q, k, v)
    for b in range(bh):
        one = flash_attention(tq[b][None, :, None], tk[b // 3][None, :, None],
                              tv[b // 3][None, :, None], causal=True)
        np.testing.assert_allclose(got[b].numpy(), one[0, :, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_strided_heads_are_read_in_place():
    """The (B, S, H, D) wrapper takes any strides with a contiguous last
    axis (the kernel reads them in place): a head-major tensor seen as
    (B, S, H, D) gives the same answer as its contiguous copy."""
    q, k, v = _qkv(np.random.default_rng(12), 2, 50, 50, 4, 2, 16)
    tq, tk, tv = _t(q, k, v)
    hm = lambda x: x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    got = flash_attention(hm(tq), hm(tk), hm(tv))
    want = flash_attention(tq, tk, tv)
    assert not hm(tq).is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_version_is_the_reference_oracle():
    """flash_attention_ref is the reference's flash_attention_ref."""
    q, k, v = _qkv(np.random.default_rng(13), 2, 33, 33, 4, 2, 8)
    for causal in (True, False):
        want = np.asarray(ref_oracle(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
        got = flash_attention_ref(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_wrapper_raises_instead_of_falling_back():
    """Shapes, types and devices the kernel does not take raise on every
    device; a device with no kernel raises; plain-version calls never
    count a launch."""
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 8, 2, 16))
    before = build.snapshot()
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.zeros((1, 8, 4, 24)), torch.zeros((1, 8, 2, 24)),
                        torch.zeros((1, 8, 2, 24)))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(torch.zeros((1, 8, 3, 16)), kv, kv)
    with pytest.raises(ValueError, match="unsupported dtype"):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="dtypes differ"):
        flash_attention(q, kv.half(), kv.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(torch.zeros((1, 8, 4, 32))[..., ::2], kv, kv)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    out = flash_attention(q, kv, kv)
    assert tuple(out.shape) == (1, 8, 4, 16)
    assert build.snapshot() == before


def test_compiled_blocks_fit_shared_memory():
    """Every compiled (path, head dim) fits the shared memory one block
    may use on the card, and two blocks of each path share an SM at
    D = 128.  simt stages f32: the q tile, two K and two V stages and
    the probability tile (108 KB); mma stages the input type, the q tile
    and two K/V stages (85 KB)."""
    for path in kfa.PATHS:
        for d in kfa.HEAD_DIMS:
            assert kfa.smem_bytes(path, d) <= kfa.SMEM_BUDGET, (path, d)
    assert kfa.BLOCKS == {"simt": (64, 32), "mma": (64, 64)}
    # (64 + 2*32) q/k rows of 132 floats, 2*32 v rows of 128, 64 p rows
    # of 40
    assert kfa.smem_bytes("simt", 128) == 4 * (128 * 132 + 64 * 128
                                               + 64 * 40) == 110592
    assert kfa.smem_bytes("mma", 128) == 87040
    # Zamba2's head dim 80: (64 + 4*64) rows of 88 bf16 (mma); (64 +
    # 2*32) rows of 84 floats, 2*32 of 80 and 64 of 40 (simt)
    assert kfa.smem_bytes("mma", 80) == 2 * 320 * 88 == 56320
    assert kfa.smem_bytes("simt", 80) == 4 * (128 * 84 + 64 * 80
                                              + 64 * 40) == 73728
    # two blocks an SM at every head dim: 228 KB, 1 KB of it the
    # system's for each block
    for path in kfa.PATHS:
        for d in kfa.HEAD_DIMS:
            assert 2 * (kfa.smem_bytes(path, d) + 1024) <= 233472, (path, d)
    with pytest.raises(ValueError, match="unknown path"):
        kfa.smem_bytes("wgmma", 128)


def test_simt_split_policy():
    """Causal f32 calls whose q-tiles are fewer than two waves of the
    blocks the card holds at once (two 64-row blocks an SM) split each
    tile's keys over two blocks; larger grids and non-causal calls keep
    whole tiles."""
    assert kfa.SIMT_BLOCKS_PER_SM == 2
    # the serving prefill: 16 heads x 16 tiles against 132 SMs x 2 blocks
    assert kfa.simt_split(1, 16, 1024, True, 132)
    assert not kfa.simt_split(1, 16, 1024, False, 132)
    assert kfa.simt_split(1, 1, 1, True, 132)
    # 527 tiles split, 528 (= 2 x 132 x 2) do not
    assert kfa.simt_split(1, 527, 64, True, 132)
    assert not kfa.simt_split(1, 528, 64, True, 132)
    assert not kfa.simt_split(4, 16, 2048, True, 132)
    assert kfa.simt_split(4, 16, 2048, True, 1024)


def test_compiled_tables_match_the_source():
    """The wrapper's head dims, blocks and path codes are what
    ``csrc/flash_attention.cu`` instantiates: a head dim or block asked
    of the library that it did not compile would fail only on the card."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    dims = re.search(r"#define FLASH_HEAD_DIMS\(X\) (.*)", src).group(1)
    assert tuple(map(int, re.findall(r"X\((\d+)\)", dims))) == kfa.HEAD_DIMS
    for path in kfa.PATHS:
        line = re.search(rf"#define FLASH_{path.upper()}_BLOCKS\(X\) (.*)",
                         src)
        assert line, path
        blocks = [(int(a), int(b)) for a, b in
                  re.findall(r"X\((\d+), (\d+)\)", line.group(1))]
        assert blocks == [kfa.BLOCKS[path]], path
        assert re.search(rf"FLASH_{path.upper()}_BLOCKS\(FLASH_"
                         rf"{path.upper()}_CASE\)", src), path
    codes = {name.lower(): int(code)
             for name, code in re.findall(r"kPath(\w+) = (\d)", src)}
    assert codes == kfa.PATH_CODES
    # simt is compiled for f32 alone, mma for the two 16-bit types
    assert re.search(r"case 1: return dispatch_simt<D>", src)
    assert len(re.findall(r"dispatch_simt<", src)) == 1
    assert re.findall(r"dispatch_mma<(\w+), D>", src) == ["__half",
                                                         "__nv_bfloat16"]


def _bshd(dtype, b=2, s=24, h=4, d=16, pad=0, offset=0):
    """A (B, S, H, D) view of ``dtype`` whose seq stride is H*D + pad and
    whose base sits ``offset`` elements into its storage."""
    n = b * s * (h * d + pad)
    flat = torch.zeros(n + offset, dtype=dtype)[offset:]
    return flat.view(b, s, h * d + pad)[..., :h * d].unflatten(-1, (h, d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", kfa.HEAD_DIMS)
def test_flash_path_takes_mma_for_aligned_16_bit_operands(dtype, d):
    """Contiguous f16/bf16 operands, the bhsd layout's permuted views and
    a size-1 axis of any stride take the tensor-core path at every
    compiled head dim, read in place (nothing staged)."""
    assert kfa.flash_path(dtype) == "mma"
    q, kv = _bshd(dtype, d=d), _bshd(dtype, h=2, d=d)
    bhsd = torch.zeros((6, 40, d), dtype=dtype).permute(1, 0, 2)[None]
    one = torch.zeros((1, 1, 4, d), dtype=dtype)
    assert kfa.operand_staging(q, kv, kv, bhsd, one.as_strided(
        one.shape, (3, 5, d, 1))) == (False,) * 5


def test_flash_path_takes_simt_where_mma_cannot_read():
    """The path follows the dtype alone: f32 takes the CUDA-core path
    at any layout, and 16-bit operands the mma path cannot read in place
    (a seq stride off a multiple of 8 elements, a base off 16 bytes) are
    staged onto it, never put on simt."""
    assert kfa.flash_path(torch.float32) == "simt"
    for dtype in (torch.bfloat16, torch.float16):
        assert kfa.flash_path(dtype) == "mma"
        aligned = _bshd(dtype)
        ragged = _bshd(dtype, pad=1)
        assert ragged.stride(1) % 8 and ragged.stride(-1) == 1
        shifted = _bshd(dtype, offset=1)
        assert shifted.data_ptr() % 16
        assert kfa.operand_staging(aligned, ragged, shifted) == (
            False, True, True)


# (dtype, layout) -> whether it is staged: one element of padding a seq
# row or an element's offset is off the 16-byte copies in every dtype;
# four elements of padding are whole chunks in f32 but not in 16 bits
STAGING_CASES = [
    (dtype, layout, staged)
    for dtype in (torch.float32, torch.bfloat16, torch.float16)
    for layout, staged in (
        ({}, False), ({"pad": 1}, True), ({"offset": 1}, True),
        ({"pad": 4}, dtype != torch.float32),
        ({"pad": 8}, False), ({"offset": 4}, dtype != torch.float32))]


@pytest.mark.parametrize("operand", ["q", "k", "v", "o"])
@pytest.mark.parametrize("dtype,layout,staged", STAGING_CASES, ids=str)
def test_operand_staging_by_operand_and_dtype(dtype, layout, staged,
                                              operand):
    """operand_staging flags exactly the operand whose base or strides
    the path's 16-byte copies cannot read, in each dtype."""
    ops = {"q": _bshd(dtype), "k": _bshd(dtype, h=2), "v": _bshd(dtype, h=2),
           "o": _bshd(dtype)}
    ops[operand] = _bshd(dtype, h=2 if operand in "kv" else 4, **layout)
    want = tuple(staged and name == operand for name in ops)
    assert kfa.operand_staging(*ops.values()) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("layout", [{"pad": 1}, {"offset": 1},
                                    {"pad": 3, "offset": 1}], ids=str)
def test_stage_is_an_aligned_contiguous_copy(dtype, layout):
    """stage() gives one contiguous copy from a 16-byte aligned base, in
    its own storage, with the operand's values; the copy needs no
    staging itself."""
    x = _bshd(dtype, **layout)
    x.copy_(torch.arange(x.numel()).reshape(x.shape).to(dtype))
    assert kfa.operand_staging(x) == (True,)
    y = kfa.stage(x)
    assert y.is_contiguous() and y.data_ptr() % 16 == 0
    assert y.dtype == x.dtype and y.shape == x.shape
    assert y.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert torch.equal(y, x)
    assert kfa.operand_staging(y) == (False,)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 5e-2)], ids=str)
def test_staged_call_matches_the_reference(dtype, tol):
    """A call whose q, k, v and output are all staged (seq strides off
    the 16-byte copies, bases off 16 bytes) goes through the staging and
    the write-back into the caller's output view, and equals the
    reference's Pallas kernel (interpret mode); the output view's
    padding is untouched."""
    b, s, h, hkv, d = 1, 70, 4, 2, 32
    rng = np.random.default_rng(17)
    q, k, v = _qkv(rng, b, s, s, h, hkv, d)
    views = [_bshd(dtype, b, s, h, d, pad=1),
             _bshd(dtype, b, s, hkv, d, pad=3, offset=1),
             _bshd(dtype, b, s, hkv, d, offset=1),
             _bshd(dtype, b, s, h, d, pad=5, offset=3)]
    for view, x in zip(views, (q, k, v)):
        view.copy_(torch.from_numpy(x).to(dtype))
    out = views[3]
    out.fill_(0.0)
    out.as_strided((b, s, 5), (s * (h * d + 5), h * d + 5, 1),
                   out.storage_offset() + h * d).fill_(7.0)
    assert kfa.operand_staging(*views) == (True,) * 4
    assert kfa._attend(*views, True, None) is out
    jx = lambda x: jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = np.asarray(ref_flash(jx(q), jx(k), jx(v), causal=True,
                                block_q=64, block_k=64, interpret=True),
                      np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=tol,
                               atol=tol)
    pad = out.as_strided((b, s, 5), (s * (h * d + 5), h * d + 5, 1),
                         out.storage_offset() + h * d)
    assert bool((pad == 7.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_cpu_calls_never_count_a_launch(dtype):
    """The plain version runs for CPU tensors on either path and counts
    nothing: the ledger is as it was, every kernel, path, dtype and
    tag."""
    q, kv = _bshd(dtype), _bshd(dtype, h=2)
    before = build.snapshot()
    flash_attention(q, kv, kv)
    flash_attention_bhsd(q[0].transpose(0, 1), kv[0].transpose(0, 1),
                         kv[0].transpose(0, 1))
    assert build.snapshot() == before
