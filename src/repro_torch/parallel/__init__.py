"""Multi-device training on ``torch.distributed`` (``repro.parallel``):
logical-axis sharding rules and the mesh they resolve on, the manual
collectives of the pod and expert axes, and GPipe over pods."""
