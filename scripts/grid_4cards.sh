#!/bin/bash
# The Trainer on the reference's whole grid, on 4 cards: the Mistral-8x7B
# out-of-memory at --mesh 4x1 measured and repaired, rwkv6-7b under tensor
# parallelism at full depth, TP x PP and TP x offload.  Run from the
# repository root on a machine with 4 GPUs:
#
#     bash scripts/grid_4cards.sh [OUT_DIR [RUN ...]]
#
# RUN is any of (the default: all but the LLaMA-7B pair, in this order)
#   mem3_parent   Mistral-8x7B, 3 layers, --mesh 4x1, 3 steps, the port of
#                 the checkout under $PARENT (its src/; default
#                 build/parent), through scripts/mem_probe.py
#   mem3          the same with this checkout's port and
#                 PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False, the
#                 allocator the parent ran with
#   mistral4_4x1  Mistral-8x7B, 4 layers, --mesh 4x1, 5 steps, with the
#                 launcher's allocator setting, through the probe
#   rwkv_2x2      rwkv6-7b at full depth (32 layers), --mesh 2x2, 3 steps
#   llama_pp_1x2  llama3.2-3b, --mesh 1x2 --num-stages 2, 5 steps
#   llama_2x2     llama3.2-3b, --mesh 2x2, 5 steps
#   llama7b_pp_1x2, llama7b_2x2   the same for LLaMA-7B
#   llama_2x2_offload  llama3.2-3b, --mesh 2x2 --offload, 5 steps
# on phase 6's data (github, context 16384, 65536 tokens a step, capacity
# 4096).  Each run is cut after RUN_TIMEOUT seconds (default 300); its
# rank-0 output goes to OUT_DIR/<run>.log (default chiprun_out/grid4) and
# the probe's per-rank records to OUT_DIR/<run>_mem/.  As each run ends
# the script prints its wall and one JSON summary (tokens/s over the
# steps after the first, every rank's peak, the loss and grad norm of
# every step, and for the probed runs every rank's allocated and reserved
# bytes at the end of each step's backward), or its exit code and last
# error line; last, the card's name and power limit.
set -uo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-chiprun_out/grid4}
shift || true
RUNS=("$@")
[ ${#RUNS[@]} -gt 0 ] || RUNS=(mem3_parent mem3 mistral4_4x1 rwkv_2x2
                               llama_pp_1x2 llama_2x2 llama_2x2_offload)
mkdir -p "$OUT"
ARGS=(--capacity 4096 --tokens-per-step 65536 --context 16384)
MOE=(--arch mistral-8x7b --mesh 4x1)

for name in "${RUNS[@]}"; do
    src=src
    probe=()
    unset PYTORCH_CUDA_ALLOC_CONF
    case $name in
        mem3_parent) src=${PARENT:-build/parent}/src
                     opts=("${MOE[@]}" --layers 3 --steps 3) ;;
        mem3) export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:False
              opts=("${MOE[@]}" --layers 3 --steps 3) ;;
        mistral4_4x1) opts=("${MOE[@]}" --layers 4 --steps 5) ;;
        rwkv_2x2) opts=(--arch rwkv6-7b --mesh 2x2 --steps 3) ;;
        llama_pp_1x2) opts=(--arch llama3.2-3b --mesh 1x2 --num-stages 2
                            --steps 5) ;;
        llama_2x2) opts=(--arch llama3.2-3b --mesh 2x2 --steps 5) ;;
        llama7b_pp_1x2) opts=(--arch llama-7b --mesh 1x2 --num-stages 2
                              --steps 5) ;;
        llama7b_2x2) opts=(--arch llama-7b --mesh 2x2 --steps 5) ;;
        llama_2x2_offload) opts=(--arch llama3.2-3b --mesh 2x2 --offload
                                 --steps 5) ;;
        *) echo "unknown run $name" >&2; exit 2 ;;
    esac
    case $name in
        mem3_parent|mem3|mistral4_4x1)
            probe=(scripts/mem_probe.py "$OUT/${name}_mem" --) ;;
        *) probe=(-m repro_torch.launch.train) ;;
    esac
    t0=$SECONDS
    PYTHONPATH=$src timeout -k 10 "${RUN_TIMEOUT:-300}" python \
        "${probe[@]}" "${opts[@]}" "${ARGS[@]}" \
        > "$OUT/$name.log" 2> "$OUT/$name.err"
    rc=$?
    echo "$name: rc $rc, $((SECONDS - t0)) s"
    python3 - "$OUT/$name" "$rc" <<'EOF'
import glob
import json
import sys

path, rc = sys.argv[1], int(sys.argv[2])
name = path.rsplit("/", 1)[-1]
mem = {}
for f in sorted(glob.glob(f"{path}_mem/rank*.json")):
    with open(f) as fh:
        r = json.load(fh)
    mem[r["rank"]] = {k: r[k] for k in ("steps", "reserved_max_gb",
                                        "num_alloc_retries", "num_ooms",
                                        "alloc_conf")}
with open(f"{path}.log") as f:
    got = [ln for ln in f if ln.startswith("{")]
if rc or not got:
    with open(f"{path}.err") as f:
        err = [ln.strip() for ln in f if ln.strip()]
    print(json.dumps({"run": name, "rc": rc,
                      "last_error": err[-1] if err else "", "mem": mem}))
    sys.exit(0)
r = json.loads(got[-1])
warm = [s for s in r["steps"] if s["step"] >= 2]
print(json.dumps({
    "run": name, "arch": r["arch"], "mesh": r["mesh"],
    "num_stages": r.get("num_stages", 1), "offload": r["offload"],
    "layers": r["layers"], "params_b_rank0": r["params_b"],
    "tokens_per_s_after_step_1": sum(s["tokens"] for s in warm)
    / sum(s["wall_s"] for s in warm),
    "peak_mem_gb_by_rank": r["peak_mem_gb_by_rank"],
    "cuda_alloc_conf": r.get("cuda_alloc_conf"),
    "steps": [{k: s[k] for k in ("step", "loss", "grad_norm", "waves",
                                  "wall_s")} for s in r["steps"]],
    "warm_ms_per_wave_by_composition_x_c_mult":
    r["warm_ms_per_wave_by_composition_x_c_mult"],
    "pipeline": {k: r["pipeline"][k] for k in ("bubble_measured",
                                               "bubble_analytic_by_step")}
    if "pipeline" in r else None,
    "pinned_host_gb": r["pinned_host_gb"],
    "ledger_meas": r["ledger"]["meas"], "mem": mem}))
EOF
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
