"""The control plane (counterpart of h2o3_tpu/parallel/).

`distributed` joins a cloud of processes over a ``torch.distributed``
store and holds its key/value channel and leadership; `oplog` publishes
the coordinator's REST ops and replays them on followers, with
acknowledgements, rejoin and the standby election; `ckpt` writes
control-plane checkpoints, durable job progress and search state;
`supervisor` folds heartbeats, acks and replay errors into the cloud's
health; `watchdog` acts on it (rejoins, elections, job and search
resumes); `mesh` makes a cloud of several processes a row mesh, each
process a rank holding its block of every frame's rows, with the
collectives between them. In one process the same calls answer for a
cloud of one.
"""
