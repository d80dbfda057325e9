"""Command-line entry points of the port, run as modules on the card:

    python -m lfsr_tpu_torch.scripts.train <flags>
    python -m lfsr_tpu_torch.scripts.test <flags> [--ckpt PATH] [--no_save_views]
    python -m lfsr_tpu_torch.scripts.inference <flags> [--ckpt PATH] [--out DIR] [--no_zip] [--skip_gate]
    python -m lfsr_tpu_torch.scripts.check_efficiency <flags> [--bench] [--deploy] [--detailed] [--json]
    python -m lfsr_tpu_torch.scripts.validate_submission SUBMISSION [--sample_pixels N]

The flags are the JAX package's (``lfsr_tpu_torch.cli``); each script
writes the files its JAX counterpart writes. Each ``main`` runs on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; the command
line has no switch to the CPU. A module does its work only under
``if __name__ == "__main__"``.
"""
