"""Faults planted under the timed path, for the tests that show ``correct`` comes out false.

Each patches the port in this process only (``--fault <name>``, a test's
option that no check passes), in the classes that the cell's family and
recipe name (``PORT_MODEL``, ``PORT_OPTIMIZER``):

- ``unchanged``: a train step returns its state unchanged (the update is skipped, the step still counted);
- ``half_batch``: half of each batch is left out. Training: its second half repeats its first, so the loss is
  the mean over the rest. Scoring: the second half's answers are never produced (zeros);
- ``no_exchange``: the exchange between ranks is left out (every collective of the mesh a no-op);
- ``altered_answer``: one answer altered where it is produced (a logit of the first row of every forward);
- ``altered_detection``: the last detection of every search is dropped.
"""

from __future__ import annotations

from kwsbench import harness

NAMES = ("unchanged", "half_batch", "no_exchange", "altered_answer", "altered_detection")


def plant(name: str, cell: harness.Cell) -> None:
    if name == "unchanged":
        def apply(self, st):
            st.step += 1

        harness.port(cell.recipe.PORT_OPTIMIZER).apply = apply
    elif name == "half_batch":
        from honk_tpu_torch.train import steps

        sample = steps.sample_train_batch

        def halved(*args, **kwargs):
            audio, labels = sample(*args, **kwargs)
            h = audio.shape[0] // 2
            audio[h:2 * h], labels[h:2 * h] = audio[:h].clone(), labels[:h].clone()
            return audio, labels

        steps.sample_train_batch = halved
        model = harness.port(cell.family.PORT_MODEL)
        forward = model.forward

        def half_answers(self, x, *args, **kwargs):
            out = forward(self, x, *args, **kwargs)
            if not self.training:
                out = out.clone()
                out[out.shape[0] // 2:] = 0
            return out

        model.forward = half_answers
    elif name == "no_exchange":
        from honk_tpu_torch.parallel import mesh

        mesh.DataMesh.all_reduce_ = lambda self, t: t
        mesh.DataMesh.all_reduce_grads = lambda self, grads: None
    elif name == "altered_answer":
        model = harness.port(cell.family.PORT_MODEL)
        forward = model.forward

        def altered(self, x, *args, **kwargs):
            out = forward(self, x, *args, **kwargs)
            if not self.training:
                out = out.clone()
                out[0, 0] += 1.0 + out[0].abs().max()
            return out

        model.forward = altered
    elif name == "altered_detection":
        from honk_tpu_torch.stream import streamer

        detect = streamer.detect
        streamer.detect = lambda *a, **k: detect(*a, **k)[:-1]
    else:
        raise SystemExit(f"kwsbench: no fault {name!r}")
