"""Child processes of the port (memory nodes, training ranks): each a
fresh interpreter (CUDA does not survive ``fork``) that exits when its
parent is gone, reaped by the parent with a bounded wait."""
from __future__ import annotations

import collections
import os
import subprocess
import threading
import time
from typing import List


def reap(procs: List[subprocess.Popen], grace_s: float = 0.0) -> None:
    """Wait up to ``grace_s`` for the children to exit, then terminate
    and kill what is left."""
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(2.0)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def drain(stream, tail: collections.deque) -> None:
    """Keep a child's last output lines."""
    for line in stream:
        tail.append(line)


def watch_parent(pid: int) -> None:
    """Exit this child process when its parent's process is gone."""
    def watch():
        while True:
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                os._exit(0)
            except PermissionError:
                pass
            if os.getppid() != pid:
                os._exit(0)
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True).start()
