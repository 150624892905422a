"""The card a run uses: its power limit, how many there are, and waiting for it."""

import subprocess

import torch


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("not read" where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0].strip()


def sync(device) -> None:
    """Wait for the card's queued work; nothing to wait for on a CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def require(chips: int) -> None:
    """Raise unless this machine has ``chips`` CUDA cards: a run never falls
    back to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA card (torch.cuda.is_available() is false)")
    n = torch.cuda.device_count()
    if n < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, this machine has {n}")
