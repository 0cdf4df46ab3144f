"""batch_cpu_ms: the mean over the window's queries of the CPU
milliseconds that the query's thread used inside its `batchExec` spans
(the thread's CPU time, `time.thread_time_ns()`), from the program's
spans. Beside `batch_exec_ms`, the loop's wall time, it tells host work
from waiting."""

from portbench.metrics._spans import mean_ms


def read(ctx):
    return mean_ms(ctx, lambda svc, trace: sum(
        s.cpu for s in trace if s.name == "batchExec" and s.cpu is not None))
