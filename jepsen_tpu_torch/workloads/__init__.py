"""Workloads of the port: the checkers of the transactional workloads
(:mod:`.append`, :mod:`.wr`)."""
