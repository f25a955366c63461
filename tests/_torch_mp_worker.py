"""Worker for the two-process gloo test of the port (run as a script).

One rank of dryrun_torch.py on the CPU, started directly rather than by
its launcher: the process joins the group through
jpgenc_tpu_torch.parallel.multihost with two CPU device entries of its own
(four entries in all) and runs the dry run's cases, which assert that the
distributed batches, stripes (even and ragged, fused, optimize, islow) and
the batch-split decode give every process files byte-identical to the
single-process port's and its own rows api.decode's pixels: the
counterpart of tests/_mp_worker.py. It prints the rank's DRYRUN line, then
MP_WORKER_OK <process_id>.

Usage: python tests/_torch_mp_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    pid, nproc, port = sys.argv[1], sys.argv[2], sys.argv[3]
    import dryrun_torch
    rc = dryrun_torch.main(["--ranks", nproc, "--device", "cpu",
                            "--port", port, "--rank", pid])
    if rc == 0:
        print(f"MP_WORKER_OK {pid}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
