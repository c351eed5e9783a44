#!/bin/bash
# Golden-log regression runs (the reference's run_pretrained.sh role):
# evaluates saved checkpoints under DIR/<dataset>/<model> and prints test
# metrics. Checkpoints come from train_main_table.sh (no network egress —
# the reference's Dropbox downloads do not apply here).
set -e
DIR="${1:-./retrained_models}"

eval_one() {
  local path="$1"; shift
  if [ -f "${path}/final/run_0/checkpoint.npz" ]; then
    python main.py "${path}/final/run_0" "$@" --pretrained
  else
    echo "skip ${path} (no checkpoint)"
  fi
}

eval_one "${DIR}/zinc/gatv2" gatv2 zinc --hidden 104
eval_one "${DIR}/zinc/egc_s" egc zinc --hidden 168 --egc-num-heads 8 --egc-num-bases 4 --aggrs symadd
eval_one "${DIR}/zinc/egc_m" egc zinc --hidden 124 --egc-num-heads 4 --egc-num-bases 4 --aggrs add,std,max
eval_one "${DIR}/arxiv/egc_s" egc arxiv --hidden 184 --egc-num-heads 8 --egc-num-bases 4 --aggrs symadd
eval_one "${DIR}/arxiv/egc_m" egc arxiv --hidden 136 --egc-num-heads 4 --egc-num-bases 4 --aggrs symadd,max,mean
