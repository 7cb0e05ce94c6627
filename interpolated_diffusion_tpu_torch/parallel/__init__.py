"""Multi-device layer of the port on torch.distributed (one process per GPU):
multihost bring-up, the (data, model) process mesh and data parallelism,
differentiable collectives, ring and ring-SLA sequence sharding, and expert
parallelism for the Switch-MoE FFN."""
