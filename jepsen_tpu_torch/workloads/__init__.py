"""Workloads of the port: the checkers of the transactional workloads
(:mod:`.append`, :mod:`.wr`) and of the lock and semaphore workloads
(:mod:`.lock`)."""
