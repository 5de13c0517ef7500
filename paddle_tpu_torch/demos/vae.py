"""VAE demo on the port (demos/vae/train.py; reference v1_api_demo/vae
vae_conf.py + vae_train.py).

MNIST variational autoencoder: fc encoder to (mu, log-variance), a
reparameterized gaussian sample, fc decoder; loss = reconstruction binary
cross-entropy + KL(q(z|x) || N(0,1)). The JAX script jits the whole step;
here the ELBO is torch arithmetic between two ``Topology.apply`` calls,
differentiated by autograd, and the port's ``optimizer.Adam(1e-3)``
updates the parameters in place. The reparameterisation noise comes from
a ``torch.Generator`` on the device. No hand-written kernel is on this
path (fc layers only).

    python -m paddle_tpu_torch.demos.vae [--quick] [--device cpu]

runs on the card unless ``--device cpu`` is given, and prints the JAX
script's "iter ... elbo-loss" and "decoded sample stats" lines.
"""

import argparse

import numpy as np
import torch

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type as dt
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.topology import Topology

_EPS = 1e-7


def build(data_dim, hidden, latent):
    """(encoder topology over ``image`` -> enc_mu, enc_logvar; decoder
    topology over ``z`` -> dec_out), the JAX script's layers and names."""
    x = L.data(name="image", type=dt.dense_vector(data_dim))
    e_h = L.fc(input=x, size=hidden, act=A.Tanh(), name="enc_h")
    mu = L.fc(input=e_h, size=latent, act=None, name="enc_mu")
    logvar = L.fc(input=e_h, size=latent, act=None, name="enc_logvar")

    z = L.data(name="z", type=dt.dense_vector(latent))
    d_h = L.fc(input=z, size=hidden, act=A.Tanh(), name="dec_h")
    recon = L.fc(input=d_h, size=data_dim, act=A.Sigmoid(), name="dec_out")
    return Topology([mu, logvar]), Topology(recon)


def elbo_loss(enc_topo, dec_topo, params, x01, eps):
    """The mean negative ELBO of the rows ``x01`` (pixels in [0, 1]) with
    the standard-normal noise ``eps`` (demos/vae/train.py:61-71): the
    encoder's mu and log-variance, z = mu + exp(logvar / 2) * eps, the
    decoder's reconstruction, its binary cross-entropy plus the KL
    divergence from N(0, 1). Train mode, so autograd records it (the
    layers have no train-only behaviour)."""
    enc, _ = enc_topo.apply(params, {"image": x01}, mode="train")
    mu, logvar = enc["enc_mu"], enc["enc_logvar"]
    z = mu + torch.exp(0.5 * logvar) * eps
    dec, _ = dec_topo.apply(params, {"z": z}, mode="train")
    recon = dec["dec_out"]
    bce = -torch.sum(x01 * torch.log(recon + _EPS)
                     + (1.0 - x01) * torch.log(1.0 - recon + _EPS), dim=1)
    kl = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar), dim=1)
    return torch.mean(bce + kl)


def train_step(enc_topo, dec_topo, optimizer, params, opt_state, x01, eps):
    """One Adam step on the ELBO, in place; returns the loss tensor."""
    for p in params.values():
        p.grad = None
    loss = elbo_loss(enc_topo, dec_topo, params, x01, eps)
    loss.backward()
    optimizer.step(params, {n: p.grad for n, p in params.items()},
                   opt_state)
    return loss.detach()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.demos.vae")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--num-iters", type=int, default=400)
    ap.add_argument("--latent", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.quick:
        args.batch_size, args.num_iters = 32, 15
        args.hidden = 64
    device = resolve_device(args.device)

    enc_topo, dec_topo = build(mnist.IMAGE_DIM, args.hidden, args.latent)
    params = dict(enc_topo.init_params(seed=0, device=device))
    params.update(dec_topo.init_params(seed=1, device=device))
    params = {n: p.float().requires_grad_() for n, p in params.items()}

    optimizer = opt.Adam(learning_rate=1e-3)
    opt_state = optimizer.init_state(params)

    images = np.stack([s[0] for _, s in zip(range(4096 if not args.quick
                                                  else 256),
                                            mnist.train()())])
    images01 = (images + 1.0) / 2.0  # dataset is [-1,1]; BCE wants [0,1]

    rng = np.random.RandomState(0)
    noise = torch.Generator(device=device).manual_seed(42)
    first = last = None
    for it in range(args.num_iters):
        batch = torch.from_numpy(images01[rng.randint(
            0, len(images01), size=args.batch_size)]).to(device)
        eps = torch.randn((args.batch_size, args.latent), generator=noise,
                          device=device)
        loss = float(train_step(enc_topo, dec_topo, optimizer, params,
                                opt_state, batch, eps))
        if first is None:
            first = loss
        last = loss
        if it % 50 == 0 or it == args.num_iters - 1:
            print("iter %d elbo-loss %.2f" % (it, loss))

    # decode a few prior samples (vae_train.py's sampling stage)
    z = torch.randn((8, args.latent),
                    generator=torch.Generator(device=device).manual_seed(7),
                    device=device)
    dec, _ = dec_topo.apply(params, {"z": z}, mode="test")
    samples = dec["dec_out"].float().cpu().numpy()
    print("decoded sample stats: mean %.3f std %.3f"
          % (samples.mean(), samples.std()))
    return first, last


if __name__ == "__main__":
    main()
