"""The port's benchmark: harness, seeded inputs, plain reference, trace
reduction and roofline arithmetic.  Nothing here imports JAX or the JAX
package; the plain reference (`reference`) imports nothing of the port."""
