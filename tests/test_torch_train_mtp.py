"""deepseek-v3's training loss (MLA + MoE + the multi-token-prediction
head) against the JAX reference, reduced, float32 compute: the loss and
``xent``, ``load_balance``, ``mtp`` within 1e-5 relative, every gradient
leaf (the ``mtp.*`` head's included) within 1e-4 x max|g_ref| (the
checks of ``test_torch_train_families.check_loss``).  Its own file: the
reference's jitted value_and_grad alone takes ~19 s on the host.

Also the head's place: a trainable model holds ``mtp.{proj, norm_h,
norm_e, layer}``, the bridge carries the reference's, leaf for leaf, and
a serving model drops them as it loads.
"""
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model
from test_torch_train_families import check_loss
from test_torch_threads import one_thread  # noqa: F401 (autouse)

NAME = "deepseek-v3-671b"


def test_mtp_loss_and_grads_match_reference():
    aux, grads = check_loss(NAME)
    assert set(aux) == {"xent", "load_balance", "mtp", "total"}
    head = [n for n in grads if n.startswith("mtp.")]
    assert {n.split(".")[1] for n in head} == {"proj", "norm_h", "norm_e",
                                               "layer"}
    assert all(grads[n].abs().max() > 0 for n in head
               if n.endswith("kernel"))


def test_serving_model_drops_the_head():
    cfg = reduced(get_config(NAME))
    trained = Model(cfg, compute_dtype=torch.float32, device="cpu",
                    trainable=True).init(torch.Generator().manual_seed(0))
    serving = Model(cfg, compute_dtype=torch.float32, device="cpu")
    assert serving.mtp is None
    serving.load_state_dict(trained.state_dict())
    assert set(trained.state_dict()) - set(serving.state_dict()) == {
        n for n in trained.state_dict() if n.startswith("mtp.")}
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(serving(toks), trained(toks))
