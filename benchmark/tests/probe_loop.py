"""A loop file for the harness's tests (copied into a test root as
`loop_kinds/<name>.py`): each step all-reduces one tensor over the ranks'
group, and the check compares the sum with the one it must be.

The mix's keys, all optional: "hold_mb" (rank r holds r times as many MB
from set-up on, so the ranks' peaks differ), "sleep_s" (a step's own
time), "matmul" (a square matrix product of that size a step, on the
rank's device), "fail_rank" with "fail_at" ("setup", or the window's step
at which that rank raises) and "hang_at" (the step at which it sleeps
instead of joining the all-reduce).
"""
import time

import torch
import torch.distributed as dist

from benchmark import loops


class ProbeLoop(loops.Loop):
    metric = "fwd_rays_per_s"

    def __init__(self, *args, ranks):
        super().__init__(*args)
        self.ranks = ranks
        t = self.traffic
        self.mine = t.get("fail_rank") == ranks.rank
        if self.mine and t.get("fail_at") == "setup":
            raise RuntimeError(f"rank {ranks.rank} fails in set-up (planted)")
        self.hold = torch.ones(int(t.get("hold_mb", 0) * ranks.rank * 2**18), device=ranks.device)
        n = t.get("matmul", 0)
        self.a = torch.ones(n, n, device=ranks.device) / max(n, 1) if n else None

    def step(self, i):
        s = self.step_seed(i)
        t = self.traffic
        if self.mine and t.get("fail_at") == i:
            raise RuntimeError(f"rank {self.ranks.rank} fails at step {i} (planted)")
        if self.mine and t.get("hang_at") == i:
            time.sleep(3600)
        if self.a is not None:
            self.a = self.a @ self.a
        x = torch.full((4,), float(self.ranks.rank + 1), device=self.ranks.device)
        if self.ranks.size > 1:
            dist.all_reduce(x, group=self.ranks.group)
        time.sleep(t.get("sleep_s", 0.0))
        return {"seed": s, "sum": x}

    def check(self, ref_mod, ref, out, control: bool = False) -> dict:
        n = self.ranks.size
        return {"sum_off": float((out["sum"].cpu() - n * (n + 1) / 2).abs().max())}

    def release(self):
        super().release()
        self.hold = self.a = None


LOOP = ProbeLoop
