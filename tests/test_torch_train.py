"""Training of the port against the JAX reference on the CPU: the loss
and its gradients (``repro_torch.models.transformer.loss_fn`` /
``encdec.loss_fn_encdec`` through ``repro_torch.train.step.loss_and_grads``,
against ``jax.value_and_grad`` of ``repro``'s) for every smoke config of
``PORTED_IDS`` in fp32.  Parameters are initialized by ``repro`` and
converted; token, label and embedding inputs are made by numpy from a seed.
Tolerances in ``_train_parity``.  Remat, the stacked leaves' backward, the
MoE at its capacities and the chunked forms: ``test_torch_train_paths.py``."""

import pytest

from _train_parity import DECODER_IDS, check_grads, make_batch, setup_pair


@pytest.mark.parametrize("arch", DECODER_IDS)
def test_loss_and_grads_match_reference(arch):
    """Dense, Gemma-2 (window, softcaps, post-norms, tied head), RWKV-6,
    Jamba, the two MoE LMs and Phi-3-vision with its prefix (whose rows the
    loss drops)."""
    jcfg, jparams, tcfg, tparams = setup_pair(arch)
    check_grads(jcfg, jparams, tcfg, tparams, make_batch(tcfg, 2, 12))


def test_encdec_loss_and_grads_match_reference():
    """Whisper: ``loss_fn_encdec`` through the fp32 log-softmax, gradients
    into the encoder, the cross-attention and the frame positions."""
    jcfg, jparams, tcfg, tparams = setup_pair("whisper_base")
    _, grads = check_grads(jcfg, jparams, tcfg, tparams,
                           make_batch(tcfg, 2, 10))
    assert float(grads["enc_pos"].abs().max()) > 0
    assert float(grads["enc"]["self"]["wq"]["w"].abs().max()) > 0
