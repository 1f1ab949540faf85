#!/usr/bin/env bash
# Run chip_smoke.py from two or more checkouts on one card, in turns and
# then in the reverse order (A, B, B, A; or A, B, C, C, B, A: the order
# that spreads the card's drift over all), each from the root of its own
# checkout so that each builds its own kernels.
#
#   bash tools/chip_ab.sh [--logs <directory>] <checkout A> <checkout B> ...
#
# A checkout is a tree unpacked from `git archive` into a directory that
# .gitignore lists, e.g. for the parent commit and the working tree:
#
#   mkdir -p build/ab/parent build/ab/change
#   git archive HEAD~1 | tar -x -C build/ab/parent
#   git add -A && git archive "$(git write-tree)" | tar -x -C build/ab/change
#
# Each run's stdout and stderr go to <directory>/<n>_<letter>.{out,err}
# (default build/ab_logs); the script prints each run's exit code, its
# kernel records and its serving and profile lines. It exits non-zero if
# any run failed.
set -u
logs=build/ab_logs
if [ "${1:-}" = --logs ]; then
  logs=$2
  shift 2
fi
if [ $# -lt 2 ]; then
  echo "usage: bash tools/chip_ab.sh [--logs <directory>] <checkout A> <checkout B> ..." >&2
  exit 2
fi
mkdir -p "$logs"
out=$(cd "$logs" && pwd)
dirs=("$@")
order=()
for ((i = 0; i < ${#dirs[@]}; i++)); do order+=("$i"); done
for ((i = ${#dirs[@]} - 1; i >= 0; i--)); do order+=("$i"); done
letters=(A B C D E F G H)
status=0
n=0
for i in "${order[@]}"; do
  n=$((n + 1))
  dir=${dirs[$i]}
  side=${letters[$i]}
  log="$out/${n}_${side}"
  (cd "$dir" && python3 chip_smoke.py > "$log.out" 2> "$log.err")
  rc=$?
  [ $rc -eq 0 ] || status=1
  echo "== run $n ($side: $dir) exit $rc"
  grep -E '^\[(kernel|serve|profile|forward|build)' "$log.err" \
    | grep -E 'ragged_paged_attention|all_layers|paged_kv_update|launches per|\[serve|\[forward|\[build' \
    | cut -c1-900
  tail -n 2 "$log.out"
done
exit $status
