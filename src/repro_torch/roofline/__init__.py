"""The dry-run's count of one rank's program on ``meta`` (``count``) and
its roofline on an H100 (``analysis``)."""
