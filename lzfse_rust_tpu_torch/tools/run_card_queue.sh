#!/bin/bash
# Card runbook: runs the port's measurement tools one at a time on an
# NVIDIA GPU, each under its own timeout, logging each to
# $CARDQ_DIR/<job>.log (default build/cardq in this checkout, so another
# tree's markers never count here). A job whose .ok marker exists is
# skipped, so a cut run resumes where it stopped; delete the markers to run
# everything again.
#
# Usage, from the repository root:
#   bash lzfse_rust_tpu_torch/tools/run_card_queue.sh [job ...]
# (default: every job, in order; exits 1 after the first failed
# correctness check, and non-zero if any job failed).
set -u
cd "$(dirname "$0")/../.."
DIR=${CARDQ_DIR:-build/cardq}
mkdir -p "$DIR"
FAILED=0

run() { # name timeout_s module [args...]
  local name=$1 tmo=$2 mod=$3; shift 3
  if [ -e "$DIR/$name.ok" ]; then echo "SKIP $name (done)"; return 0; fi
  echo "RUN  $name: $mod $* (timeout ${tmo}s) at $(date +%H:%M:%S)"
  local t0=$SECONDS
  if timeout -k 10 "$tmo" python3 -m "lzfse_rust_tpu_torch.tools.$mod" "$@" \
      >"$DIR/$name.log" 2>&1; then
    touch "$DIR/$name.ok"
    echo "OK   $name in $((SECONDS - t0)) s"; tail -3 "$DIR/$name.log"
  else
    local rc=$?
    echo "FAIL $name (rc=$rc) after $((SECONDS - t0)) s: see $DIR/$name.log"
    tail -5 "$DIR/$name.log"; FAILED=1
    return 1
  fi
}

# membership among args 2..n
want() { [ $# -le 1 ] || [[ " ${*:2} " == *" $1 "* ]]; }
ARGS=("$@")

# 0. the benchmark: full decode of the serving batch (SHA-gated), the
# host baselines and the full encode
want bench "${ARGS[@]}"       && { run bench 900 bench || exit 1; }
# 1. correctness gates first: full decode and encode byte identity
want corpus "${ARGS[@]}"      && { run corpus 600 check_corpus || exit 1; }
want enc_id "${ARGS[@]}"      && { run enc_id 600 check_encoder_corpus || exit 1; }
# 2. probes of the TPU op mixes
want step "${ARGS[@]}"        && run step 300 microbench_step
want multisym "${ARGS[@]}"    && run multisym 300 microbench_step --multisym
want vpu "${ARGS[@]}"         && run vpu 300 microbench_vpu
# 3. decode kernels and stages
want split "${ARGS[@]}"       && run split 300 bench_stage_split
want entropy "${ARGS[@]}"     && run entropy 300 bench_entropy_decode
want step_probe "${ARGS[@]}"  && run step_probe 600 decode_step_probe
want profile "${ARGS[@]}"     && run profile 600 profile_device_stages
want upload "${ARGS[@]}"      && run upload 300 microbench_upload
want rebuild "${ARGS[@]}"     && run rebuild 300 bench_rebuild
want per_file "${ARGS[@]}"    && run per_file 900 bench_per_file
# 4. encode kernels and stages
want enc_kernels "${ARGS[@]}" && run enc_kernels 300 bench_encode_kernels
want enc_e2e "${ARGS[@]}"     && run enc_e2e 600 bench_encode_e2e
want match_find "${ARGS[@]}"  && run match_find 600 bench_match_find
want rowgather "${ARGS[@]}"   && run rowgather 300 microbench_rowgather
# 5. the public API's host engines per kind, beside the card's decode
want api_corpus "${ARGS[@]}"  && run api_corpus 600 bench_corpus
# 6. shape model
want util "${ARGS[@]}"        && run util 300 predict_utilization
# 7. several devices: the mesh decode over 1, 2 and 4 shards; processes
# joined over NCCL, one a card
want scaling "${ARGS[@]}"     && run scaling 600 bench_scaling
want multihost "${ARGS[@]}"   && run multihost 300 demo_multihost --device cuda \
  --hosts "$(python3 -c 'import torch; print(max(torch.cuda.device_count(), 1))')"

echo "QUEUE DONE at $(date +%H:%M:%S)"
exit $FAILED
