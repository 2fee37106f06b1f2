"""The port's copies of the reference's host-only `repro.core` modules that
the gateway and the serve launcher need: the durable `TaskQueue` with its
leases and journal (`queue`, `tasks`), and the result store and dashboards
(`results`, `reporting`). The sweep's workers, scheduler and population
training are not ported yet.
"""
