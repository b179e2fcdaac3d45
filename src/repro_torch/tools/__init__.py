"""Command-line tools over the port's analysis package:

  * ``python -m repro_torch.tools.emlint`` — workflow verifier and source
    self-lint;
  * ``python -m repro_torch.tools.emcheck`` — schedule-space model
    checking with minimized, replayable reproducers;
  * ``python -m repro_torch.tools.emtop`` — text view of an
    ``EmeraldRuntime.introspect()`` snapshot.
"""
