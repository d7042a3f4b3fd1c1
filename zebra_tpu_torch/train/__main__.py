"""``python -m zebra_tpu_torch.train …``: the port's training CLI
(:mod:`zebra_tpu_torch.cli`)."""

from zebra_tpu_torch.cli import main

if __name__ == "__main__":
    main()
