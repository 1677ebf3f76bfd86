"""The control plane's one-process half (counterpart of
h2o3_tpu/parallel/).

The REST handlers call these modules at the same sites as the
reference's, so the multi-process half can fill them in without touching
the routes. In one process the answers are fixed: one process, index 0,
no oplog, a HEALTHY cloud. `ckpt` holds the durable job progress and
search state, which one process needs too. The oplog follower and
replay, control-plane checkpoints, the recovery watchdog, the
supervisor's state machine over heartbeats, the mesh and the retry
layer on a ``torch.distributed`` store come with the multi-process
control plane (ROADMAP A14.4).
"""
