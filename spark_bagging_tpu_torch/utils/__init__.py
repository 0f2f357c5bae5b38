"""Host-side utilities: device policy, params protocol, datasets,
memory budget and the kernel build."""
