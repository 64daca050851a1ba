"""The processes of the port's CPU rank tests (tests/test_torch_dist_*.py):
``Procs`` runs a test file as a script in several processes at once (gloo
ranks, JAX references), joins them under a time limit and fails the
tests on a non-zero exit, with the end of each process's log."""
import subprocess
import sys
import time
from pathlib import Path

import pytest


class Procs:
    """``script`` run with each of ``argvs``, all started at once, logs in
    ``d``; ``wait()`` joins them within ``timeout`` seconds of the start."""

    def __init__(self, name, script, argvs, env, d: Path, timeout: float):
        self.name, self.timeout, self.t0 = name, timeout, time.monotonic()
        self.procs, self.logs = [], []
        for i, argv in enumerate(argvs):
            log = d / f"{name}-log{i}.txt"
            self.logs.append(log)
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, script, *argv], env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        self.done = False

    def wait(self):
        if not self.done:
            for p in self.procs:
                left = max(1.0, self.timeout
                           - (time.monotonic() - self.t0))
                try:
                    p.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    self.kill()
                    pytest.fail(f"{self.name}: a process ran past "
                                f"{self.timeout} s (a hung collective?)")
            bad = [(i, p.returncode, log.read_text()[-3000:])
                   for i, (p, log) in enumerate(zip(self.procs, self.logs))
                   if p.returncode]
            assert not bad, f"{self.name} failed: {bad}"
            self.done = True

    def kill(self):
        for p in self.procs:
            p.kill()
            p.wait()
