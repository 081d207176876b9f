"""The streaming step's sharding layer; one device for now
(time_parallel.py, the single-time-shard part of the reference's)."""
