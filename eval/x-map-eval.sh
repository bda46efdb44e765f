#!/bin/bash

# Full offline evaluation: computes MC3D, ESL (init + refined GT) and
# X-maps depth maps for the 9 ESL static sequences, then prints the
# paper-Table-1 style comparison (reference: eval/x-map-eval.sh).
#
# Unlike the reference, no GNU-parallel process fan-out is needed: every
# method is a dense device program that batches scans on one chip (and
# eval_xmaps can shard sequences across devices in one program).

set -euo pipefail

compute_mc3d=${COMPUTE_MC3D:-true}
compute_esl=${COMPUTE_ESL:-true}
compute_xmaps=${COMPUTE_XMAPS:-true}

data_folder="${1:-${XMAPS_ESL_DATA:-${ESL_DATA:-/ESL_data}}}"
static_folder="$data_folder/static"
mkdir -p "$static_folder"

script_dir="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
"$script_dir/download_esl_static_scans.sh" "$data_folder"

calib_yaml="${data_folder}/calib.yaml"

for seq_id in 1 2 3 4 5 6 7 8 9
do
    seq_folder="${static_folder}/seq$seq_id/"
    echo "Processing sequence $seq_id @ $seq_folder"

    num_scans=$(ls "$seq_folder"/scans_np/*.npy | wc -l)
    echo "Number of scans: $num_scans"

    if [ "$compute_mc3d" = true ]; then
        echo "Running MC3D baseline..."
        python3 -m xmaps.apps.eval_mc3d -object_dir "${seq_folder}" \
            -num_scans "${num_scans}" -calib "${calib_yaml}"
    fi

    if [ "$compute_esl" = true ]; then
        echo "Running ESL (init + refined GT)..."
        python3 -m xmaps.apps.eval_esl -object_dir "${seq_folder}" \
            -num_scans "${num_scans}" -calib "${calib_yaml}"
    fi

    if [ "$compute_xmaps" = true ]; then
        echo "Running X-maps..."
        python3 -m xmaps.apps.eval_xmaps -object_dir "${seq_folder}" \
            -num_scans "${num_scans}" -calib "${calib_yaml}"
    fi
done

echo "Running evaluation script to compare results..."
python3 -m xmaps.apps.eval_table -object_dir "${static_folder}" -max_depth 500
