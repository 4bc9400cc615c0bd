"""Entry points of the port: batched serving (`serve`), training on one
device or a mesh (`train`), the meshes (`mesh`), the dry-run of every cell
on a fake mesh (`dryrun`) and the warm broadcast-plan service
(`planserver`)."""
