"""The port's object plane: the cases of ``test_zero_copy.py`` and
``test_native_codec.py`` run against ``ray_tpu_torch``, and torch tensors
through the store.

numpy values keep the reference's contract: a large value's ``get`` is a
read-only view that aliases the shared segment. A tensor's ``get`` is a
CPU tensor that owns its memory (``_private/serialization.py``: write
protection by copy), bf16 bit for bit, a CUDA tensor restored on the
host. The native codec is the reference's source, so its blobs are
byte-equal to the reference's for the same frames.
"""
import numpy as np
import pytest
import torch

from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

from ray_tpu_torch import _native
from ray_tpu_torch._private.serialization import (get_context, pack_frames,
                                                  pack_frames_into,
                                                  packed_size,
                                                  unpack_frames)
from ray_tpu_torch.core.worker import CoreWorker

FRAMES = [b"header", np.arange(257).tobytes(), b"", b"z" * 1009]


# --------------------------------------------------------------- zero copy


def test_get_is_zero_copy_and_readonly(rt_port):
    rt = rt_port
    arr = np.arange(8 << 20, dtype=np.uint8)  # 8MB -> shm tier
    ref = rt.put(arr)
    out = rt.get(ref)
    frames = CoreWorker._current._load_frames(ref.object_id)
    raw = np.frombuffer(frames[-1], dtype=np.uint8)
    # Aliases the segment (no copy was made)...
    assert np.shares_memory(out, raw)
    # ...and is immutable, so user writes can't corrupt the stored
    # value for other readers (plasma semantics).
    assert not out.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        out[0] = 1


def test_zero_copy_view_device_put(rt_port):
    """``device_put_shm`` stages a zero-copy view as a tensor that owns
    its memory (here on the CPU; the card's case is
    ``test_cuda_tensor_round_trip``)."""
    from ray_tpu_torch.utils.device import device_put_shm, transfer_stats

    rt = rt_port
    arr = np.ones((512, 512), dtype=np.float32)  # 1MB -> shm
    out = rt.get(rt.put(arr))
    transfer_stats(reset=True)
    dev = device_put_shm(out, device="cpu")
    assert isinstance(dev, torch.Tensor)
    assert float(dev.sum()) == 512 * 512
    assert dev.data_ptr() != out.ctypes.data
    tree = device_put_shm({"a": out, "b": [out.T]}, device="cpu")
    assert torch.equal(tree["b"][0], dev.T)
    st = transfer_stats()
    assert st["calls"] == 2 and st["copies"] == 1
    assert st["bytes"] == 3 * arr.nbytes


def test_inline_values_snapshot_and_readonly(rt_port):
    """Inline (non-shm) values are snapshotted at put time: mutating
    the source array after put, or the array a get returned, never
    changes the stored value (matches the reference's immutable-object
    semantics at every size)."""
    rt = rt_port
    src = np.arange(16, dtype=np.int64)
    ref = rt.put(src)
    src[0] = -1  # putter mutates AFTER put
    out = rt.get(ref)
    assert out[0] == 0  # snapshot, not an alias
    assert not out.flags.writeable
    assert rt.get(ref)[0] == 0


# ----------------------------------------------------------------- tensors


@pytest.mark.parametrize("size", [16, 1 << 20], ids=["inline", "shm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_tensor_round_trip(rt_port, dtype, size):
    """f32, bf16 and int64 tensors, inline and through a shm segment,
    come back bit-equal with their dtype and shape."""
    rt = rt_port
    g = torch.Generator().manual_seed(size)
    if dtype == "int64":
        t = torch.randint(-2**40, 2**40, (size,), generator=g)
    else:
        t = torch.randn(size, generator=g).to(getattr(torch, dtype))
    t = t.reshape(4, -1)
    out = rt.get(rt.put(t))
    assert out.dtype == t.dtype and out.shape == t.shape
    assert out.device.type == "cpu" and out.is_contiguous()
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()]
    assert torch.equal(out.view(width), t.view(width))


def test_tensor_non_contiguous_and_parameter(rt_port):
    """A transposed view arrives contiguous with the view's values; a
    Parameter stays a Parameter with its ``requires_grad``; a tensor in
    a task's result keeps its dtype."""
    rt = rt_port
    base = torch.arange(6 * 1024, dtype=torch.float32).reshape(6, 1024)
    view = base.t()[::2]
    assert not view.is_contiguous()
    out = rt.get(rt.put(view))
    assert out.is_contiguous() and torch.equal(out, view)
    p = torch.nn.Parameter(torch.ones(3, 5))
    q = rt.get(rt.put({"w": p}))["w"]
    assert isinstance(q, torch.nn.Parameter) and q.requires_grad
    assert torch.equal(q.detach(), p.detach())

    @rt.remote
    def halves(x):
        return x[:, :2].to(torch.bfloat16), x.sum()

    got = rt.get(halves.remote(view))
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], view[:, :2].to(torch.bfloat16))
    assert float(got[1]) == float(view.sum())


@pytest.mark.parametrize("size", [16, 1 << 20], ids=["inline", "shm"])
def test_tensor_write_protection(rt_port, size):
    """A write to one ``get``'s tensor never changes what another ``get``
    of the same ref returns: each ``get`` owns a copy."""
    rt = rt_port
    t = torch.arange(size, dtype=torch.float32)
    ref = rt.put(t)
    a = rt.get(ref)
    a.add_(1.0)
    a[0] = -5.0
    b = rt.get(ref)
    assert torch.equal(b, t)
    assert a.data_ptr() != b.data_ptr()

    @rt.remote
    def mutate_and_sum(x):
        x.mul_(0)
        return float(x.sum())

    assert rt.get(mutate_and_sum.remote(ref)) == 0.0
    assert torch.equal(rt.get(ref), t)


def test_tensor_framing_is_out_of_band():
    """A tensor's body rides its own frame (so it lands in shm without a
    copy into the pickle stream), as a numpy array's does."""
    ctx = get_context()
    t = torch.zeros(1 << 16, dtype=torch.bfloat16)
    frames = ctx.serialize({"t": t})
    assert len(frames) == 3 and len(frames[-1]) == t.numel() * 2
    assert len(frames[1]) < 1024
    back = ctx.deserialize(frames)["t"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


@pytest.mark.cuda
def test_cuda_tensor_round_trip(rt_port):
    """A CUDA tensor that the driver puts arrives as a CPU tensor, equal
    bit for bit; ``device_put_shm`` stages it back on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ray_tpu_torch.utils.device import device_put_shm

    rt = rt_port
    t = torch.randn(1024, 1024, device="cuda").to(torch.bfloat16)
    out = rt.get(rt.put(t))
    assert out.device.type == "cpu" and out.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), t.cpu().view(torch.int16))
    back = device_put_shm(out)
    assert back.is_cuda and torch.equal(back, t)


# ------------------------------------------------------------ native codec


def test_native_builds():
    assert _native.load() is not None, \
        "native codec failed to build (g++ is in the image)"
    assert _native.which().startswith("native (")
    assert "build/native" in _native.which()


def test_roundtrip_and_python_parity(monkeypatch):
    blob_native = pack_frames(FRAMES)
    got = [bytes(f) for f in unpack_frames(blob_native)]
    assert got == [bytes(f) for f in FRAMES]

    # force the pure-python path; blobs must be byte-identical
    monkeypatch.setattr(_native, "_mod", None)
    monkeypatch.setattr(_native, "_tried", True)
    blob_py = pack_frames(FRAMES)
    assert blob_py == blob_native
    got = [bytes(f) for f in unpack_frames(blob_native)]
    assert got == [bytes(f) for f in FRAMES]


def test_pack_frames_equal_to_reference():
    """The port's blob for the same frames is byte-equal to the
    reference's codec's (its native path, and the Python fallback)."""
    from ray_tpu._private.serialization import pack_frames as ref_pack

    frames = FRAMES + [torch.arange(100, dtype=torch.int16).numpy()
                       .tobytes()]
    assert pack_frames(frames) == ref_pack(frames)
    assert pack_frames([]) == ref_pack([])


def test_scatter_into_buffer():
    size = packed_size(FRAMES)
    buf = bytearray(size + 32)
    written = pack_frames_into(memoryview(buf), 16, FRAMES)
    assert written == size
    out = unpack_frames(memoryview(buf)[16:16 + size])
    assert [bytes(f) for f in out] == [bytes(f) for f in FRAMES]


def test_corrupt_blob_rejected():
    nat = _native.load()
    assert nat is not None
    with pytest.raises(ValueError):
        nat.frame_offsets(b"\x05\x00")  # truncated header
    bad = pack_frames([b"abcd"])[:-2]  # frame overruns blob
    with pytest.raises(ValueError):
        nat.frame_offsets(bad)


def test_shm_store_uses_codec(rt_port):
    rt = rt_port
    arr = np.random.default_rng(0).random(1 << 18)
    ref = rt.put(arr)  # large → shm tier → pack_frames_into path
    np.testing.assert_array_equal(rt.get(ref), arr)


def test_sweeps_leave_the_other_package_alone():
    """Both packages' heads sweep a dead session's shm domain by name
    prefix: the port's ``rtt_`` segments and the reference's ``rt_`` ones
    never match each other's sweep, even for the same domain string."""
    import os

    from ray_tpu._private import object_store as ref_os
    from ray_tpu._private.ids import ObjectID as RefID
    from ray_tpu_torch._private import object_store as port_os
    from ray_tpu_torch._private.ids import ObjectID

    domain = f"sweep-test.{os.getpid()}"
    port = port_os.SharedMemoryStore(1 << 20, domain=domain)
    ref = ref_os.SharedMemoryStore(1 << 20, domain=domain)
    pid, rid = ObjectID.from_random(), RefID.from_random()
    port.create(pid, [b"port"])
    ref.create(rid, [b"reference"])
    names = {"port": port._name(pid), "ref": ref._name(rid)}
    assert names["port"].startswith("rtt_")
    assert names["ref"].startswith("rt_") and \
        not names["ref"].startswith("rtt_")
    try:
        assert ref_os.sweep_domain_segments(domain) == 1
        assert os.path.exists("/dev/shm/" + names["port"])
        assert not os.path.exists("/dev/shm/" + names["ref"])
        ref.create(rid, [b"reference"])
        assert port_os.sweep_domain_segments(domain) == 1
        assert os.path.exists("/dev/shm/" + names["ref"])
        assert not os.path.exists("/dev/shm/" + names["port"])
    finally:
        port.shutdown()
        ref.shutdown()
        for name in names.values():
            try:
                os.unlink("/dev/shm/" + name)
            except OSError:
                pass
