"""Co-design helpers of the port. The planner and ``KernelSpace`` come with
the H100 codesign slice; for now only the tile arithmetic is here."""

from repro_torch.codesign.space import repair_tile, round_up  # noqa: F401
