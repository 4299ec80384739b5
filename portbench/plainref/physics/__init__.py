"""Rigid-body dynamics (counterpart of ``surtr_tpu/physics``): scene
construction, the step with every ``PhysicsConfig`` route of the JAX
package (kernels B5 pack, B6 and B12 broadphases, B7 narrowphase, B8 contact
prep and B9 solver on the kernel route; the XLA formulations in plain
PyTorch), scene queries and the batched step."""
