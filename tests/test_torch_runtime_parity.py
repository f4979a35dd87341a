"""The port's runtime against ``ray_tpu``'s: same bytes, separate names.

* The wire frames (``_private/wire.py``, the RPC length prefix of
  ``_private/protocol.py``) and the serialized object layout for numpy
  payloads (``_private/serialization.py``) are byte-identical to
  ``ray_tpu``'s on the same seeded inputs.
* A ``ray_tpu`` cluster and a ``ray_tpu_torch`` cluster running at once
  leave each other's shm segments, spill dirs and log dirs alone, and each
  package's sweeper passes over the other's live and dead-owner names.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import log_monitor as jax_logs
from ray_tpu._private import plasma as jax_plasma
from ray_tpu._private import protocol as jax_protocol
from ray_tpu._private import raylet as jax_raylet
from ray_tpu._private import serialization as jax_ser
from ray_tpu._private import wire as jax_wire
from ray_tpu_torch._private import log_monitor as port_logs
from ray_tpu_torch._private import plasma as port_plasma
from ray_tpu_torch._private import protocol as port_protocol
from ray_tpu_torch._private import raylet as port_raylet
from ray_tpu_torch._private import serialization as port_ser
from ray_tpu_torch._private import wire as port_wire


def _seeded_messages(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        depth = int(rng.integers(1, 4))
        msg = {"type": f"t{i}", "seq": int(rng.integers(-2**40, 2**40)),
               "f": float(rng.standard_normal()),
               "s": "".join(chr(int(c)) for c in rng.integers(32, 0x2fff, 9)),
               "b": rng.bytes(int(rng.integers(0, 200)))}
        for _ in range(depth):
            msg = {"inner": msg, "l": [int(x) for x in rng.integers(0, 9, 3)],
                   "t": (None, True, 2**70)}
        out.append(msg)
    return out


MESSAGES = _seeded_messages()
BIG = {"data": np.random.default_rng(1).bytes(jax_wire.OOB_THRESHOLD + 17),
       "chunk": 4}
PICKLED = {"err": ValueError("boom"), "set": {1, 2, 3}}


def test_wire_constants_match():
    for name in ("MAGIC", "WIRE_VERSION", "REQUEST", "REPLY", "NOTIFY",
                 "BATCH", "BODY_PICKLE", "BODY_MARSHAL", "BODY_TAGGED",
                 "OOB_THRESHOLD", "HEADER_SIZE", "HELLO_TYPE"):
        assert getattr(port_wire, name) == getattr(jax_wire, name), name
    assert port_wire.hello_message() == jax_wire.hello_message()
    assert port_protocol._HEADER.format == jax_protocol._HEADER.format


@pytest.mark.parametrize("fast", [True, False])
def test_frames_are_byte_identical(fast):
    for rid, msg in enumerate(MESSAGES + [BIG, PICKLED, None]):
        for kind in (jax_wire.REQUEST, jax_wire.REPLY, jax_wire.NOTIFY):
            a = jax_wire.encode_frame(kind, rid * 7919, msg, fast=fast)
            b = port_wire.encode_frame(kind, rid * 7919, msg, fast=fast)
            assert bytes(a) == bytes(b), (kind, rid)
            kind_b, rid_b, _ = port_wire.decode_frame(a)
            assert (kind_b, rid_b) == (kind, rid * 7919)
        assert jax_wire.encode_value(msg) == port_wire.encode_value(msg)


def test_batch_frames_are_byte_identical():
    items = [(jax_wire.REQUEST, i, m) for i, m in enumerate(MESSAGES)]
    assert jax_wire.encode_batch_frame_fast(items) == \
        port_wire.encode_batch_frame_fast(items)
    parts_a = [jax_wire.encode_batch_item(k, i, m) for k, i, m in items] + [
        jax_wire.encode_batch_item(jax_wire.REPLY, 99, PICKLED),
        jax_wire.encode_batch_item(jax_wire.NOTIFY, 100, BIG)]
    parts_b = [port_wire.encode_batch_item(k, i, m) for k, i, m in items] + [
        port_wire.encode_batch_item(port_wire.REPLY, 99, PICKLED),
        port_wire.encode_batch_item(port_wire.NOTIFY, 100, BIG)]
    assert parts_a == parts_b
    assert bytes(jax_wire.encode_batch_frame(parts_a)) == \
        bytes(port_wire.encode_batch_frame(parts_b))


def _numpy_payloads(seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((64, 33)).astype(np.float32),
        rng.integers(-9, 9, (5, 7, 3)).astype(np.int64),
        rng.standard_normal(300_000),
        np.asfortranarray(rng.standard_normal((8, 9))),
        rng.standard_normal((4, 6))[:, ::2],
        np.array(3.5, np.float16),
        rng.random((10,)) > 0.5,
        np.zeros((0, 4), np.float32),
        {"wte": rng.standard_normal((32, 16)).astype(np.float32),
         "blocks": [{"w": rng.standard_normal((16, 16)).astype(np.float32),
                     "b": np.zeros(16, np.float32)} for _ in range(3)],
         "step": 7, "name": "tree"},
        [np.arange(5), (np.ones(3, np.uint8), None, 1.5)],
    ]


@pytest.mark.parametrize("i", range(len(_numpy_payloads())))
def test_serialized_numpy_layout_is_byte_identical(i):
    value = _numpy_payloads()[i]
    a = jax_ser.get_context().serialize(value)
    b = port_ser.get_context().serialize(value)
    assert a.inband_size == b.inband_size
    assert a.to_bytes() == b.to_bytes()
    for data in (a.to_bytes(), b.to_bytes()):
        assert repr(port_ser.get_context().deserialize_bytes(data)) == \
            repr(value)


def _touch(path, is_dir=False):
    if is_dir:
        os.makedirs(path, exist_ok=True)
    else:
        with open(path, "wb") as f:
            f.write(b"x")


def test_each_sweeper_leaves_the_other_packages_names_alone():
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    live = os.getpid()
    tmp = tempfile.gettempdir()
    # 16 hex digits: both sweepers take any length, while the JAX
    # package's hygiene test, which may run meanwhile in another worker,
    # counts only names of 12.
    a, b, c, d = ("a" * 16, "b" * 16, "c" * 16, "d" * 16)
    names = {
        "jax_seg_dead": f"/dev/shm/rt_{dead.pid}_{a}",
        "jax_seg_live": f"/dev/shm/rt_{live}_{b}",
        "port_seg_dead": f"/dev/shm/rtt_{dead.pid}_{c}",
        "port_seg_live": f"/dev/shm/rtt_{live}_{d}",
        "jax_spill_dead": os.path.join(tmp, f"rt_spill_{dead.pid}_{a}"),
        "port_spill_dead": os.path.join(tmp, f"rtt_spill_{dead.pid}_{c}"),
        "port_spill_live": os.path.join(tmp, f"rtt_spill_{live}_{d}"),
    }
    for key, path in names.items():
        _touch(path, is_dir="spill" in key)
    try:
        port_plasma.sweep_orphan_segments()
        port_raylet._sweep_orphan_spill_dirs()
        assert not os.path.exists(names["port_seg_dead"])
        assert not os.path.exists(names["port_spill_dead"])
        for key in ("jax_seg_dead", "jax_seg_live", "port_seg_live",
                    "jax_spill_dead", "port_spill_live"):
            assert os.path.exists(names[key]), key
        _touch(names["port_seg_dead"])
        _touch(names["port_spill_dead"], is_dir=True)
        jax_plasma.sweep_orphan_segments()
        jax_raylet._sweep_orphan_spill_dirs()
        assert not os.path.exists(names["jax_seg_dead"])
        assert not os.path.exists(names["jax_spill_dead"])
        for key in ("jax_seg_live", "port_seg_dead", "port_seg_live",
                    "port_spill_dead", "port_spill_live"):
            assert os.path.exists(names[key]), key
    finally:
        import shutil
        for key, path in names.items():
            if "spill" in key:
                shutil.rmtree(path, ignore_errors=True)
            elif os.path.exists(path):
                os.unlink(path)


def test_clusters_of_both_packages_run_side_by_side():
    assert jax_logs.default_log_dir("ab" * 8) != \
        port_logs.default_log_dir("ab" * 8)
    jax_info = ray_tpu.init(num_cpus=1,
                            _worker_env={"JAX_PLATFORMS": "cpu"})
    try:
        port_info = ray_tpu_torch.init(num_cpus=1)
        try:
            assert jax_info["store_name"].startswith(
                f"/rt_{jax_info['pid']}_")
            assert port_info["store_name"].startswith(
                f"/rtt_{port_info['pid']}_")
            big = np.arange(400_000, dtype=np.float32)
            jax_ref, port_ref = ray_tpu.put(big), ray_tpu_torch.put(big * 2)
            np.testing.assert_array_equal(ray_tpu.get(jax_ref), big)
            np.testing.assert_array_equal(ray_tpu_torch.get(port_ref),
                                          big * 2)
        finally:
            ray_tpu_torch.shutdown()
        # The port's shutdown took only its own segment.
        assert os.path.exists("/dev/shm" + jax_info["store_name"])
        assert not os.path.exists("/dev/shm" + port_info["store_name"])
        np.testing.assert_array_equal(ray_tpu.get(jax_ref), big)
    finally:
        ray_tpu.shutdown()
    assert not os.path.exists("/dev/shm" + jax_info["store_name"])
