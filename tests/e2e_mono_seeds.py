"""The port's mono e2e orbit (`entry.e2e_entry("mono")`, the reference's
TestMonoLoopEndToEnd fixture in tests/test_loop_e2e.py) on a CUDA card for
client seeds 1..N, with the reference's gates for each seed: how often a
seed meets them. `chip_smoke.py` runs client seed 1 only.

    python3 tests/e2e_mono_seeds.py [N]     (N defaults to 8)

Run from the root of the checkout. Each seed's run is `chip_smoke.py`'s
e2e phase (it enforces the free scale, the bootstrap, finite orthonormal
poses and the training launches); the last line is one JSON object per
seed: the gates, the loops (kf_q, kf_c, s), the similarity keyframe ATE and
the first LOST frame.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402

GATES = ("finite_orthonormal", "distant_loop", "keyframe_ate", "free_scale", "scale")


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    if not torch.cuda.is_available():
        raise SystemExit("e2e_mono_seeds: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    seeds = {}
    for cl in range(1, n + 1):
        ep = cs.run_e2e_phase("mono", client_id=cl)
        seeds[cl] = dict(ep["gates"], loops=ep["loops"], keyframe_ate_m=ep["keyframe_ate_m"],
                         first_lost=next((i for i, x in ep["not_ok"] if x == "LOST"), None))
    met = [cl for cl, g in seeds.items() if all(g[k] for k in GATES)]
    print(f"the reference's gates met with client seeds {met} of 1..{n}", flush=True)
    print(json.dumps(seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
