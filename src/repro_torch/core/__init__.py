"""The battery pool: job tables, schedule policies, the pool's job
function and round runners, stitching and verdicts, and the public
``RunSpec`` -> ``PoolSession`` -> ``BatteryRun`` API."""
