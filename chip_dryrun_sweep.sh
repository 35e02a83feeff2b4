#!/usr/bin/env bash
# The dry run's full production sweep on one machine: every (arch x
# shape) cell of `python -m repro_torch.launch.dryrun --all --mesh
# production` on the (16, 16) and (2, 16, 16) meshes, one process per
# arch (xlstm-1.3b one per cell: its sLSTM scans take the longest), all
# started together; then the records' table and the roofline table of
# `python -m repro_torch.roofline.analysis` for each mesh.
#
#     bash chip_dryrun_sweep.sh [OUT_DIR]   (default build/dryrun_torch/production)
export PYTHONPATH=src
O=${1:-build/dryrun_torch/production}
mkdir -p "$O/logs"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import torch; print(torch.__version__)'
S0=$(date +%s)
for a in $(python -m repro_torch.launch.dryrun --list-archs \
           | grep -vx xlstm-1.3b); do
  (s=$(date +%s)
   timeout 3200 python -m repro_torch.launch.dryrun --all --mesh production \
       --arch $a --out "$O" > "$O/logs/$a.txt" 2>&1
   echo "arch $a rc=$? wall=$(( $(date +%s) - s ))") &
done
for sh in decode_32k prefill_32k long_500k train_4k; do
  for mp in "" --multi-pod; do
    (s=$(date +%s)
     timeout 3200 python -m repro_torch.launch.dryrun --mesh production \
         --arch xlstm-1.3b --shape $sh $mp --out "$O" \
         > "$O/logs/xlstm_${sh}${mp}.txt" 2>&1
     echo "cell xlstm-1.3b $sh $mp rc=$? wall=$(( $(date +%s) - s ))") &
  done
done
wait
echo "sweep wall $(( $(date +%s) - S0 ))"
for t in sp mp; do
  echo "== $t"
  python -m repro_torch.roofline.analysis --dryrun-dir "$O" --tag $t --records
  python -m repro_torch.roofline.analysis --dryrun-dir "$O" --tag $t
done
grep -h "OK\|Error" "$O"/logs/*.txt | grep -v "^\[rank0\]:W" | cut -c1-260
