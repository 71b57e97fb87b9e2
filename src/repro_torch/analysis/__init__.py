"""Offline analysis: the static verification subsystem
(`repro_torch.analysis.check`), which design-rule checks pinned plans
against the H100 and lints the threaded serve stack without executing
anything."""
