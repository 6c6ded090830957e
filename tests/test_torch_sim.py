"""The port's deterministic sim runtime (utils/sim.py, the ChainDB's
decoupled mode runs on it) against the JAX package's, after the
reference's `tests/test_sim.py`: each program runs under both schedulers
and must leave the same log (virtual times, message order, wakeups, the
seeded schedules)."""

import pytest

from ouroboros_consensus_tpu.utils import sim as j_sim
from ouroboros_consensus_tpu_torch.utils import sim as p_sim


def sleep_ordering(m):
    log = []

    def t(name, dt):
        yield m.Sleep(dt)
        log.append((name, dt))

    m.run_sim([("a", t("a", 3)), ("b", t("b", 1)), ("c", t("c", 2))])
    return log


def same_time_fifo(m):
    log = []

    def t(name):
        yield m.Sleep(5)
        log.append(name)

    m.run_sim([("a", t("a")), ("b", t("b")), ("c", t("c"))])
    return log


def channel_delay(m):
    chan, got = m.Channel(delay=2.5), []

    def sender():
        yield m.Send(chan, "hello")
        yield m.Send(chan, "again")

    def receiver(sim):
        for _ in range(2):
            msg = yield m.Recv(chan)
            got.append((sim.now, msg))

    sim = m.Sim()
    sim.spawn(receiver(sim), "rx")
    sim.spawn(sender(), "tx")
    sim.run()
    return got


def event_broadcast(m):
    ev, woken = m.Event(), []

    def waiter(name):
        yield m.Wait(ev)
        woken.append(name)

    def firer():
        yield m.Sleep(1)
        yield m.Fire(ev)

    m.run_sim([("w1", waiter("w1")), ("w2", waiter("w2")), ("f", firer())])
    return woken


def spawn_and_stop(m):
    log = []

    def child():
        yield m.Sleep(1)
        log.append("child")

    def parent():
        task = yield m.Spawn(child(), "child")
        log.append(("parent", task.name))
        yield m.Stop()
        log.append("unreachable")

    m.run_sim([("p", parent())])
    return log


def ping_pong(m, seed=None):
    chan, log = m.Channel(delay=0.5), []

    def ping():
        for i in range(3):
            yield m.Send(chan, i)
            yield m.Sleep(1)

    def pong(sim):
        for _ in range(3):
            msg = yield m.Recv(chan)
            log.append((sim.now, msg))

    sim = m.Sim(seed=seed)
    sim.spawn(pong(sim), "pong")
    sim.spawn(ping(), "ping")
    sim.run()
    return log


def seeded_workers(m, seed):
    sim, order = m.Sim(seed=seed), []

    def worker(i):
        for _ in range(3):
            order.append(i)
            yield m.Sleep(1.0)

    for i in range(4):
        sim.spawn(worker(i), f"w{i}")
    sim.run()
    return order


def recv_timeout(m):
    log = []

    def consumer(ch):
        got = yield m.RecvTimeout(ch, 1.0)
        log.append(("first", got is m.TIMEOUT))
        got = yield m.RecvTimeout(ch, 5.0)
        log.append(("second", got))

    def producer(ch):
        yield m.Sleep(2.0)
        yield m.Send(ch, "late")

    sim, ch = m.Sim(), m.Channel()
    sim.spawn(consumer(ch), "c")
    sim.spawn(producer(ch), "p")
    sim.run()
    return log, sim.now


def run_until(m):
    log = []

    def ticker(sim):
        while True:
            yield m.Sleep(0.75)
            log.append(sim.now)

    sim = m.Sim()
    sim.spawn(ticker(sim), "t")
    return log, sim.run(until=5.0)


PROGRAMS = {
    "sleep-ordering": sleep_ordering, "same-time-fifo": same_time_fifo,
    "channel-delay": channel_delay, "event-broadcast": event_broadcast,
    "spawn-and-stop": spawn_and_stop, "ping-pong": ping_pong,
    "recv-timeout": recv_timeout, "run-until": run_until,
    **{f"seed-{s}": (lambda m, s=s: seeded_workers(m, s)) for s in (None, 1, 2, 3, 4, 5)},
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_same_log_as_the_reference(name):
    assert PROGRAMS[name](p_sim) == PROGRAMS[name](j_sim)


def test_seeds_explore_and_replay():
    base = seeded_workers(p_sim, None)
    assert base == [0, 1, 2, 3] * 3
    runs = {s: seeded_workers(p_sim, s) for s in (1, 2, 3, 4, 5)}
    assert any(o != base for o in runs.values())
    assert all(seeded_workers(p_sim, s) == o and sorted(o) == sorted(base)
               for s, o in runs.items())


def test_task_failure_propagates():
    def bad(m):
        yield m.Sleep(1)
        raise ValueError("boom")

    for m in (j_sim, p_sim):
        with pytest.raises(m.TaskFailed) as info:
            m.run_sim([("bad", bad(m))])
        assert isinstance(info.value.exc, ValueError) and info.value.task_name == "bad"


def test_livelock_guard():
    def spin(m):
        while True:
            yield m.Sleep(0)

    for m in (j_sim, p_sim):
        sim = m.Sim()
        sim.spawn(spin(m), "spin")
        with pytest.raises(RuntimeError, match="max_steps"):
            sim.run(max_steps=1000)
