"""torch tensors through the port's object store.

Round trips through ``put``/``get`` and task arguments at every dtype the
port computes in (bf16 included, which numpy lacks), non-contiguous and
0-d tensors, tensors inside containers beside numpy arrays; a got tensor
is a copy, so an in-place update of it leaves the stored object as it was.
The serializer's own cases (CUDA staging, ``requires_grad``) run without a
cluster.  This module imports no JAX and nothing of ``ray_tpu``: the
cluster's workers import it.
"""

import numpy as np
import pytest
import torch
from _torch_runtime import ray_start  # noqa: F401

import ray_tpu_torch
from ray_tpu_torch._private.serialization import (SerializationContext,
                                                  _rebuild_tensor)

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int64,
          torch.bool]


def _tensor(dtype, shape=(3, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) > 0.5
    if dtype == torch.int64:
        return torch.randint(-1000, 1000, shape, generator=g)
    return torch.randn(shape, generator=g).to(dtype)


@ray_tpu_torch.remote
def identity(x):
    return x


@ray_tpu_torch.remote
def describe(t):
    return str(t.dtype), tuple(t.shape), t.is_contiguous()


def _same(a, b):
    assert isinstance(b, torch.Tensor)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_put_get_and_task_arg_roundtrip(ray_start, dtype):
    x = _tensor(dtype)
    _same(x, ray_tpu_torch.get(ray_tpu_torch.put(x)))
    _same(x, ray_tpu_torch.get(identity.remote(x)))
    assert ray_tpu_torch.get(describe.remote(x)) == (str(dtype), (3, 5),
                                                     True)


def test_large_bf16_tensor_goes_through_plasma(ray_start):
    x = _tensor(torch.bfloat16, shape=(512, 1024))   # 1 MiB, out of band
    ref = ray_tpu_torch.put(x)
    _same(x, ray_tpu_torch.get(ref))
    _same(x, ray_tpu_torch.get(identity.remote(ref)))


def test_non_contiguous_and_zero_d(ray_start):
    x = _tensor(torch.float32, shape=(4, 6)).t()[::2]
    assert not x.is_contiguous()
    out = ray_tpu_torch.get(ray_tpu_torch.put(x))
    _same(x, out)
    assert out.is_contiguous()
    for z in (torch.tensor(3.5), torch.tensor(True),
              torch.tensor(7, dtype=torch.int64),
              torch.tensor(1.25, dtype=torch.bfloat16)):
        _same(z, ray_tpu_torch.get(ray_tpu_torch.put(z)))
        _same(z, ray_tpu_torch.get(identity.remote(z)))
    empty = torch.zeros((0, 3), dtype=torch.bfloat16)
    _same(empty, ray_tpu_torch.get(ray_tpu_torch.put(empty)))


def test_tensors_in_containers_beside_numpy(ray_start):
    rng = np.random.default_rng(0)
    value = {"w": _tensor(torch.bfloat16), "b": [_tensor(torch.float16, (7,)),
                                                 rng.standard_normal(300_000)],
             "n": rng.integers(0, 9, (4, 4)), "s": "tag"}
    for out in (ray_tpu_torch.get(ray_tpu_torch.put(value)),
                ray_tpu_torch.get(identity.remote(value))):
        _same(value["w"], out["w"])
        _same(value["b"][0], out["b"][0])
        np.testing.assert_array_equal(out["b"][1], value["b"][1])
        np.testing.assert_array_equal(out["n"], value["n"])
        assert out["s"] == "tag"


def test_in_place_update_of_a_got_tensor_leaves_the_object(ray_start):
    x = _tensor(torch.float32, shape=(256, 1024))      # plasma-sized
    ref = ray_tpu_torch.put(x)
    first = ray_tpu_torch.get(ref)
    first.add_(1.0)
    first[0, 0] = -7.0
    _same(x, ray_tpu_torch.get(ref))
    small = ray_tpu_torch.put(torch.ones(3))           # inline-sized
    got = ray_tpu_torch.get(small)
    got.zero_()
    _same(torch.ones(3), ray_tpu_torch.get(small))


def test_requires_grad_is_dropped_and_parameters_become_tensors():
    ctx = SerializationContext()
    p = torch.nn.Parameter(torch.ones(2, 3))
    out = ctx.deserialize_bytes(ctx.serialize(
        {"p": p, "g": p * 2}).to_bytes())
    assert type(out["p"]) is torch.Tensor and not out["p"].requires_grad
    assert not out["g"].requires_grad
    _same(p.detach(), out["p"])
    _same((p * 2).detach(), out["g"])


def test_cuda_tensor_lands_on_the_cpu_without_a_card(monkeypatch):
    """A tensor that left a card comes back on the CPU in a process that
    sees none (the flag the card path sets, rebuilt here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _tensor(torch.bfloat16)
    raw = x.reshape(-1).view(torch.uint8).numpy().tobytes()
    out = _rebuild_tensor(raw, "bfloat16", (3, 5), True)
    assert out.device.type == "cpu"
    _same(x, out)


def test_tensor_pickling_outside_the_store_is_left_alone():
    """The reducers live in the serializer's own pickler: torch.save and
    plain pickle keep torch's own format."""
    import io
    import pickle
    ctx = SerializationContext()
    ctx.serialize(torch.ones(2))            # registers the reducers
    buf = io.BytesIO()
    torch.save({"t": torch.arange(4)}, buf)
    buf.seek(0)
    assert torch.equal(torch.load(buf)["t"], torch.arange(4))
    assert b"ray_tpu_torch" not in pickle.dumps(torch.ones(2))
