#!/usr/bin/env bash
# Two trees of this repository on one GPU, in one go, in turns: other, this,
# this, other - so that the host and the card are the same for both and a
# drift shows up as a difference between the two runs of one tree.
#
#   git archive <commit> | tar -x -C _parent      # _parent/ is git-ignored
#   bash scripts/torch_compare_trees.sh _parent [out_dir]
#
# Per turn: chip_smoke.py (kernel times, main-path frames/s), then
# scripts/torch_profile_main_path.py for the default and the -sd -ofix
# configuration (device-busy ms, launches per batch, time by kernel); at the
# end one DoG profile of each tree. Results go to out_dir (default
# compare_out/, git-ignored) as smoke_<turn>.txt and
# profile_<config>_<turn>.json, turns 1 and 4 being the other tree. Needs one
# CUDA device and nvcc.
set -u
other=${1:?usage: torch_compare_trees.sh OTHER_TREE [OUT_DIR]}
here=$(cd "$(dirname "$0")/.." && pwd)
other=$(cd "$other" && pwd)
out=${2:-$here/compare_out}
mkdir -p "$out"
out=$(cd "$out" && pwd)

turn=0
for tree in "$other" "$here" "$here" "$other"; do
    turn=$((turn + 1))
    (cd "$tree" && python3 chip_smoke.py > "$out/smoke_$turn.txt" \
        2> "$out/smoke_$turn.err")
    echo "chip_smoke.py turn $turn ($tree): exit $?"
done
for cfg in default sd-ofix; do
    turn=0
    for tree in "$other" "$here" "$here" "$other"; do
        turn=$((turn + 1))
        (cd "$tree" && python3 scripts/torch_profile_main_path.py \
            --config $cfg > "$out/profile_${cfg}_$turn.json" \
            2> "$out/profile_${cfg}_$turn.err")
        echo "profile $cfg turn $turn ($tree): exit $?"
    done
done
(cd "$here" && python3 scripts/torch_profile_main_path.py --detector dog \
    > "$out/profile_dog_this.json" 2> "$out/profile_dog_this.err")
(cd "$other" && python3 scripts/torch_profile_main_path.py --detector dog \
    > "$out/profile_dog_other.json" 2> "$out/profile_dog_other.err")
echo "results in $out"
