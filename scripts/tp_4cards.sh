#!/bin/bash
# Tensor parallelism on 4 cards: the port's launcher at --mesh 2x2 beside
# --mesh 4x1 for llama3.2-3b (28 layers) and LLaMA-7B (32), and a 2x2
# checkpoint resumed at 4x1.  Run from the repository root on a machine
# with 4 GPUs:
#
#     bash scripts/tp_4cards.sh [OUT_DIR]
#
# Each run's rank-0 output goes to OUT_DIR/<run>.log (default
# chiprun_out/tp4); the last lines printed are the card's name and power
# limit and one JSON summary per run (tokens/s over steps 2-5, every
# rank's peak memory, the loss and grad norm of every step) and of the
# resume (step 6 at 4x1 from the 2x2 checkpoint of step 5, against step 6
# of the uninterrupted 2x2 run).  The checkpoints (51.4 GB each) go to a
# directory of this run's own under /dev/shm, since the disk holds one of
# them, not two; it is removed when the script exits.
set -euo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-chiprun_out/tp4}
mkdir -p "$OUT"
CK=$(mktemp -d /dev/shm/tp4_ckpt.XXXXXX)
trap 'rm -rf "$CK"' EXIT
export PYTHONPATH=src
ARGS=(--capacity 4096 --tokens-per-step 65536 --context 16384)

run() {
    local name=$1
    shift
    local t0=$SECONDS
    python -m repro_torch.launch.train "$@" "${ARGS[@]}" \
        > "$OUT/$name.log" 2> "$OUT/$name.err"
    echo "$name: $((SECONDS - t0)) s"
}

run llama_4x1 --arch llama3.2-3b --mesh 4x1 --steps 5
run llama7b_4x1 --arch llama-7b --mesh 4x1 --steps 5
run llama7b_2x2 --arch llama-7b --mesh 2x2 --steps 5
run llama_2x2 --arch llama3.2-3b --mesh 2x2 --steps 6 --ckpt-dir "$CK"
rm -rf "$CK/step_6"             # resume the periodic checkpoint of step 5
run llama_4x1_resumed --arch llama3.2-3b --mesh 4x1 --steps 6 \
    --ckpt-dir "$CK"
rm -rf "$CK"/step_*

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 - "$OUT" <<'EOF'
import json
import sys

out = sys.argv[1]


def rec(name):
    with open(f"{out}/{name}.log") as f:
        return json.loads([ln for ln in f if ln.startswith("{")][-1])


for name in ("llama_4x1", "llama_2x2", "llama7b_4x1", "llama7b_2x2"):
    r = rec(name)
    warm = [s for s in r["steps"] if 2 <= s["step"] <= 5]
    print(json.dumps({
        "run": name, "mesh": r["mesh"], "arch": r["arch"],
        "layers": r["layers"],
        "tokens_per_s_steps_2_5": sum(s["tokens"] for s in warm)
        / sum(s["wall_s"] for s in warm),
        "peak_mem_gb_by_rank": r["peak_mem_gb_by_rank"],
        "steps": [{k: s[k] for k in ("step", "loss", "grad_norm", "waves",
                                      "wall_s")} for s in r["steps"]],
        "zero1_bytes": r["zero1_bytes"], "ckpt": r["ckpt"]}))
full = {s["step"]: s for s in rec("llama_2x2")["steps"]}
res = rec("llama_4x1_resumed")
(step,) = res["steps"]
print(json.dumps({
    "resume": "2x2 step 5 -> 4x1", "resumed_at": res["resumed_at"],
    "step": step["step"], "loss": step["loss"],
    "loss_uninterrupted": full[step["step"]]["loss"],
    "loss_rel": abs(step["loss"] - full[step["step"]]["loss"])
    / abs(full[step["step"]]["loss"]),
    "grad_norm": step["grad_norm"],
    "grad_norm_uninterrupted": full[step["step"]]["grad_norm"],
    "grad_norm_rel": abs(step["grad_norm"] - full[step["step"]]["grad_norm"])
    / abs(full[step["step"]]["grad_norm"]),
    "restore_s": res["ckpt"].get("restore_s")}))
EOF
