"""Training checkpoints: step-numbered directories, keep-N rotation,
atomic saves written off the training thread.

Counterpart of `prompt_diffusion_tpu/training/checkpoint.py` (an orbax
CheckpointManager there), without orbax. A checkpoint of step N is the
directory `<root>/<N>/` holding the `TrainState`'s tensors in
`state.safetensors` (`tools/safetensors_io.py`) and its counters and
names in `meta.json`. A save copies the tensors to host memory on the
calling thread, so training may go on changing them, then writes
`<root>/.tmp-<N>/` on a worker thread and renames it to `<root>/<N>/`: a
directory with a step's name is always whole. `save` keeps the orbax
rules: a step is saved when it is a multiple of `save_every` and later than
the latest saved step, or when forced; after each save only the newest
`keep` steps stay (None keeps all).

A sharded state (`TrainState(mesh=)`) is saved in the same one-card
format: every rank takes part in the gather of the whole tensors, global
rank 0 decides whether to save (from its files, so every rank agrees) and
writes; every rank restores its chunk from the file, so a checkpoint saved
at any world size restores at any other.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

from prompt_diffusion_tpu_torch.parallel.mesh import barrier, is_rank0, rank0_value
from prompt_diffusion_tpu_torch.tools import safetensors_io

_TENSORS, _META = "state.safetensors", "meta.json"


class CheckpointManager:
    def __init__(self, directory: str, save_every: int = 1000, keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.save_every, self.keep = save_every, keep
        os.makedirs(self.directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Tuple[int, Future]] = []
        self._lock = threading.Lock()

    def all_steps(self) -> List[int]:
        """The saved steps, oldest first (a save still being written is
        not among them)."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        with self._lock:
            steps += [s for s, f in self._pending if not f.done()]
        return max(steps) if steps else None

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        return (latest is None or step > latest) and step % self.save_every == 0

    def save(self, step: int, state, force: bool = False) -> bool:
        """Saves `state` (a `TrainState`) as step `step` when the rules above
        allow it or `force`; returns whether it did."""
        mesh = getattr(state, "mesh", None)
        if not rank0_value(force or self.should_save(step), mesh):
            return False
        tensors = state.tensors()  # with a mesh: gathered on every rank
        if not is_rank0(mesh):
            return True
        tensors = {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}
        meta = state.meta()
        future = self._pool.submit(self._write, step, tensors, meta)
        with self._lock:
            self._pending.append((step, future))
        return True

    def _write(self, step: int, tensors, meta) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        safetensors_io.save_file(tensors, os.path.join(tmp, _TENSORS))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.directory, str(step)))
        if self.keep is not None:
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait_until_finished(self) -> None:
        """Waits for every save; raises the first save's error."""
        with self._lock:
            pending, self._pending = self._pending, []
        for _, f in pending:
            f.result()

    def restore(self, step: int, state) -> None:
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        dev = state.params[0].device if state.params else "cpu"
        state.load(safetensors_io.load_file(os.path.join(path, _TENSORS), device=dev), meta)

    def close(self) -> None:
        self.wait_until_finished()
        self._pool.shutdown()


def make_manager(directory: str, save_every: int = 1000,
                 keep: Optional[int] = None) -> CheckpointManager:
    """keep=None keeps all (PL save_top_k=-1 semantics, train.py:231)."""
    return CheckpointManager(directory, save_every, keep)


def save_state(manager: CheckpointManager, step: int, state, force: bool = False) -> bool:
    return manager.save(step, state, force=force)


def restore_state(manager: CheckpointManager, template, step: Optional[int] = None
                  ) -> Tuple[object, Optional[int]]:
    """Loads step `step` (None: the latest) into `template`, a `TrainState`
    of the same run. Returns (state, restored step), or (template, None)
    when there is no checkpoint."""
    manager.wait_until_finished()
    mesh = getattr(template, "mesh", None)
    barrier(mesh)
    step = rank0_value(step if step is not None else manager.latest_step(), mesh)
    if step is None:
        return template, None
    manager.restore(step, template)
    return template, step


def resume(manager: CheckpointManager, state) -> int:
    """Restores the latest checkpoint into `state` and returns the loop
    step to run next: 0 with no checkpoint, else the saved step + 1 (a
    checkpoint holds the state after loop step N, `state.step` N + 1;
    running N again would apply its update twice)."""
    state, restored = restore_state(manager, state)
    start = 0 if restored is None else restored + 1
    if state.step != start:
        raise RuntimeError(f"the restored state is at step {state.step}, not {start}")
    return start


def save_final(manager: CheckpointManager, step: int, state) -> None:
    """The end-of-run save: the last step is usually not a multiple of
    `save_every`, and without it the last partial interval of updates
    would be lost. Nothing happens when `step` is already saved."""
    manager.wait_until_finished()
    mesh = getattr(state, "mesh", None)
    if rank0_value(manager.latest_step() != step, mesh):
        manager.save(step, state, force=True)
    manager.wait_until_finished()
    barrier(mesh)  # every rank sees the files rank 0 wrote

