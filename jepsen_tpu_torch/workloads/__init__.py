"""Workloads of the port: the checkers of the transactional workloads
(:mod:`.append`, :mod:`.wr`), of the lock and semaphore workloads
(:mod:`.lock`), and of the bank, causal, long-fork and Adya G2 workloads
(:mod:`.bank`, :mod:`.causal`, :mod:`.long_fork`, :mod:`.adya`)."""

# What the workloads' generators, workload maps and test maps raise: they
# run tests rather than check them, and need the port of the reference's
# generator/, client.py and core.py.
RUNNER_SLICE = ("this workload's generators and test maps run tests rather than check "
                "them; they come with the port's test runner (ROADMAP item A17)")
