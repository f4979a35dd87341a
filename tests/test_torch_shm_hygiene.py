"""Object-store/session hygiene of the port's runtime: no leaked shm
segments or spill dirs.  Case for case those of ``test_shm_hygiene.py``,
on the port's own prefix:
  * segment names embed the owner pid (``/rtt_<pid>_<node12>``),
  * raylet startup sweeps segments/spill dirs whose owner pid is dead,
  * clean shutdown unlinks via close() + an atexit net.
The session checks look only at the segments of the session they start
(named by its daemon's pid): other test workers may run clusters at the
same time.  That the two packages' sweepers leave each other's names
alone is held in ``test_torch_runtime_parity.py``.
Reference analog: plasma store teardown in
``src/ray/object_manager/plasma/store_runner.cc``.
"""

import os
import re
import subprocess
import sys
import time

import pytest

from ray_tpu_torch._private import plasma as plasma_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rtt_segments(pid=None):
    owner = str(pid) if pid is not None else r"\d+"
    try:
        return {e for e in os.listdir("/dev/shm")
                if re.match(rf"rtt_({owner}_)?[0-9a-f]{{12}}$", e)}
    except OSError:
        return set()


def _driver(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)


def test_segment_name_embeds_pid():
    name = plasma_mod.segment_name("ab" * 12)
    assert name == f"/rtt_{os.getpid()}_{'ab' * 6}"


def test_sweeper_reaps_dead_pid_and_legacy_segments(tmp_path):
    me = os.getpid()
    # A "legacy" (un-pidded) name and a dead-pid name must both go; a
    # live-pid name must survive.
    dead_pid = subprocess.Popen([sys.executable, "-c", "pass"])
    dead_pid.wait()
    legacy = "/dev/shm/rtt_aaaaaaaaaaaa"          # old + legacy -> swept
    fresh_legacy = "/dev/shm/rtt_dddddddddddd"    # young legacy -> kept
    dead = f"/dev/shm/rtt_{dead_pid.pid}_bbbbbbbbbbbb"
    live = f"/dev/shm/rtt_{me}_cccccccccccc"
    for p in (legacy, fresh_legacy, dead, live):
        with open(p, "wb") as f:
            f.write(b"x")
    old = time.time() - 2 * plasma_mod._LEGACY_MIN_AGE_S
    os.utime(legacy, (old, old))
    try:
        removed = plasma_mod.sweep_orphan_segments()
        assert removed >= 2
        assert not os.path.exists(legacy)
        assert not os.path.exists(dead)
        assert os.path.exists(live)
        assert os.path.exists(fresh_legacy)  # live pre-upgrade session safe
    finally:
        for p in (legacy, fresh_legacy, dead, live):
            try:
                os.unlink(p)
            except OSError:
                pass


def test_cluster_roundtrip_leaves_no_segments():
    """A full init/shutdown must remove every segment and spill dir of its
    session."""
    code = (
        "import ray_tpu_torch as rt;"
        "info = rt.init(num_cpus=1);"
        "print(info['pid'], flush=True);"
        "assert rt.get(rt.put(41)) == 41;"
        "rt.shutdown()")
    proc = _driver(code)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    daemon_pid = int(out.split()[0])
    assert _rtt_segments(daemon_pid) == set()
    import tempfile
    spill = [e for e in os.listdir(tempfile.gettempdir())
             if e.startswith(f"rtt_spill_{daemon_pid}_")]
    assert spill == []


def test_sigkilled_raylet_segment_reaped_by_next_session():
    """SIGKILL the whole session (atexit never runs), then verify the next
    raylet's startup sweep removes the orphan."""
    code = (
        "import ray_tpu_torch as rt;"
        "info = rt.init(num_cpus=1);"
        "print('READY', info['pid'], flush=True);"
        "import time; time.sleep(60)")
    proc = _driver(code)
    ready, daemon_pid = proc.stdout.readline().split()
    assert ready == "READY"
    assert _rtt_segments(daemon_pid)
    # Kill the driver AND its daemon children hard (no atexit anywhere).
    subprocess.run(["pkill", "-9", "-P", str(proc.pid)], check=False)
    proc.kill()
    proc.wait()
    deadline = time.time() + 10
    dead_orphan = None
    while time.time() < deadline and dead_orphan is None:
        for seg in _rtt_segments(daemon_pid):
            if not os.path.exists(f"/proc/{daemon_pid}"):
                dead_orphan = seg
                break
        if dead_orphan is None:
            time.sleep(0.5)
    if dead_orphan is None:
        pytest.skip("kill race left no dead-owner segment to sweep")
    removed = plasma_mod.sweep_orphan_segments()
    assert removed >= 1
    assert dead_orphan not in _rtt_segments()


def test_store_larger_than_dev_shm_is_refused():
    """tmpfs backs pages only when written: a store larger than the free
    room would die of SIGBUS later, so creating it raises instead."""
    st = os.statvfs("/dev/shm")
    too_big = st.f_bavail * st.f_frsize + (1 << 30)
    with pytest.raises(plasma_mod.ObjectStoreFullError, match="/dev/shm"):
        plasma_mod.PlasmaClient(f"/rtt_{os.getpid()}_{'ee' * 6}",
                                capacity=too_big, create=True)
    assert _rtt_segments(os.getpid()) == set()
