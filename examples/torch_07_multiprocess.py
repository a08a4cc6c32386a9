"""Multi-process sharded build and serving on arrowspace_torch (the flow
of 07_multiprocess.py), over torch.distributed.

Each worker process (arrowspace_torch/parallel/mp_worker.py) joins one
process group (tcp://localhost, a free port), holds its row slice as
shards, and runs the seeded sharded build -> λ -> query -> serving path;
the launcher returns process 0's checks.  On the card the group is NCCL,
one process per card (this machine's cards, each holding 4 shards); on
the CPU it is gloo, 2 processes x 4 shards.

    python examples/torch_07_multiprocess.py               # NCCL, cards
    python examples/torch_07_multiprocess.py --device cpu  # gloo, CPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch


def main():
    from arrowspace_torch.parallel.multiprocess import \
        run_multiprocess_dryrun

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    device = torch.device(p.parse_args().device)
    if device.type == "cuda":
        nproc, dev = max(1, torch.cuda.device_count()), "cuda"
    else:
        nproc, dev = 2, "cpu"
    print(f"launching {nproc} localhost process(es) x 4 shards on {dev} "
          f"...", flush=True)
    res = run_multiprocess_dryrun(num_processes=nproc, local_devices=4,
                                  n_rows=65536, f=64, device=dev)
    print("process 0 reports:")
    for key, val in res.items():
        print(f"  {key}: {val}")
    assert res.get("process_count") == nproc
    assert res.get("ok"), res
    print("\nmulti-process sharded build -> query -> serve: OK")


if __name__ == "__main__":
    main()
