"""Experiment CLI (counterpart of ``dmel_tpu/experiments/cli.py``, with
the same flags):

    python -m dmel_tpu_torch.experiments.cli --name esc50_synth \
        --num_samples 1 --max_epochs 100 \
        --output_dir ./results_torch --data_dir ./data

``--output_dir`` holds one directory per sweep; sweeps are resumable
(finished trials are skipped on re-invocation).  The trials run on the
GPU; ``--device cpu`` runs them on the CPU.  ``--pack`` trains every
trial as one pack on the card (``runner.run_sweep_packed``), each trial
stopping on its own patience.
"""

from __future__ import annotations

import argparse

from dmel_tpu_torch.experiments.runner import run_sweep, run_sweep_packed


def main(argv=None):
    parser = argparse.ArgumentParser(description="Hyperparameter search.")
    parser.add_argument("--num_samples", required=True, type=int,
                        help="The number of repeats of every grid point.")
    parser.add_argument("--max_epochs", required=True, type=int,
                        help="The maximum number of epochs.")
    parser.add_argument("--name", required=True, type=str,
                        help="Search-space name (time_frequency / "
                             "audio_mnist / esc50 / esc50_synth / fsd).")
    parser.add_argument("--output_dir", required=True, type=str,
                        help="Directory for sweep results.")
    parser.add_argument("--data_dir", required=True, type=str,
                        help="Dataset root directory.")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--no_resume", action="store_true",
                        help="Re-run finished trials instead of skipping.")
    parser.add_argument("--pack", action="store_true",
                        help="Run all trials as one program (per-trial "
                             "early stop via an active-mask freeze; see "
                             "parallel/trials.py).")
    parser.add_argument("--device", type=str, default=None,
                        help="Device of the trials (default cuda).")
    args = parser.parse_args(argv)

    if args.pack:
        sweep_dir = run_sweep_packed(args.name, args.num_samples,
                                     args.max_epochs, args.output_dir,
                                     args.data_dir, verbose=args.verbose,
                                     device=args.device)
    else:
        sweep_dir = run_sweep(args.name, args.num_samples, args.max_epochs,
                              args.output_dir, args.data_dir,
                              resume=not args.no_resume,
                              verbose=args.verbose, device=args.device)
    print(f"sweep complete: {sweep_dir}")


if __name__ == "__main__":
    main()
