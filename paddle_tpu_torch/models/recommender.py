"""Recommender and CTR model topologies (paddle_tpu/models/recommender.py),
with the JAX builders' layer and parameter names.

``movielens_recommender`` is the dual-tower movielens rating model;
``movielens_score`` is its served head (the score layer alone, without
the rating label and the cost), the builder a bundle names.
``wide_deep_ctr`` is the Wide&Deep click-through-rate model: a wide
sparse part over cross-feature ids (a ``sparse_binary_vector`` fc whose
table updates by rows, ``ParamAttr(sparse_update=True)``) plus per-field
embeddings through an MLP, summed into one logit.
"""

from paddle_tpu_torch import activation as A
from paddle_tpu_torch import data_type
from paddle_tpu_torch import layer as L
from paddle_tpu_torch import pooling as pool
from paddle_tpu_torch.attr import ParamAttr
from paddle_tpu_torch.utils.error import enforce


def movielens_recommender(num_users=6041, num_movies=3953, num_genders=2,
                          num_ages=7, num_jobs=21, num_categories=19,
                          title_dict=1000, emb=32, hidden=64):
    """Dual-tower movielens rating model: user features and movie features
    each fuse into a tower vector; rating = 5 * their cosine similarity.
    Returns (score, rating, cost)."""
    user = L.data(name="user_id", type=data_type.integer_value(num_users))
    gender = L.data(name="gender_id",
                    type=data_type.integer_value(num_genders))
    age = L.data(name="age_id", type=data_type.integer_value(num_ages))
    job = L.data(name="job_id", type=data_type.integer_value(num_jobs))
    movie = L.data(name="movie_id",
                   type=data_type.integer_value(num_movies))
    cats = L.data(name="category_ids",
                  type=data_type.sparse_binary_vector(num_categories))
    title = L.data(name="movie_title",
                   type=data_type.integer_value_sequence(title_dict))

    u_feats = [
        L.embedding(input=user, size=emb, name="rec_user_emb"),
        L.embedding(input=gender, size=emb // 2, name="rec_gender_emb"),
        L.embedding(input=age, size=emb // 2, name="rec_age_emb"),
        L.embedding(input=job, size=emb // 2, name="rec_job_emb"),
    ]
    user_tower = L.fc(input=u_feats, size=hidden, act=A.Tanh(),
                      name="rec_user_tower")

    title_emb = L.embedding(input=title, size=emb, name="rec_title_emb")
    title_vec = L.pooling(input=title_emb, pooling_type=pool.SumPooling())
    m_feats = [
        L.embedding(input=movie, size=emb, name="rec_movie_emb"),
        L.fc(input=cats, size=emb // 2, name="rec_cat_fc"),
        title_vec,
    ]
    movie_tower = L.fc(input=m_feats, size=hidden, act=A.Tanh(),
                       name="rec_movie_tower")

    score = L.cos_sim(a=user_tower, b=movie_tower, scale=5.0,
                      name="rec_score")
    rating = L.data(name="rating", type=data_type.dense_vector(1))
    cost = L.square_error_cost(input=score, label=rating, name="rec_cost")
    return score, rating, cost


def movielens_score(**kwargs):
    """The served head of ``movielens_recommender(**kwargs)``: its score
    layer alone (a bundle's builder)."""
    return movielens_recommender(**kwargs)[0]


def wide_deep_ctr(sparse_dim=10000, field_dims=(1000, 1000, 100),
                  emb=16, hidden=(64, 32), sharded_mesh=None,
                  sharded_axis="model"):
    """Wide&Deep click-through-rate model. Returns (logit, label, cost):
    the click probability, the click label and the binary cross entropy.
    The wide table ``ctr_wide_w`` [sparse_dim, 1] and the field
    embeddings update by rows. The sharded embedding (``sharded_mesh``)
    is not ported yet."""
    enforce(sharded_mesh is None, "wide_deep_ctr(sharded_mesh=...): the "
            "sharded embedding (paddle.parallel) is not ported yet")
    wide_in = L.data(name="wide_features",
                     type=data_type.sparse_binary_vector(sparse_dim))
    wide = L.fc(input=wide_in, size=1, act=None, bias_attr=False,
                param_attr=ParamAttr(name="ctr_wide_w", sparse_update=True),
                name="ctr_wide")

    deep_feats = []
    for i, dim in enumerate(field_dims):
        field = L.data(name="field%d" % i, type=data_type.integer_value(dim))
        deep_feats.append(L.embedding(
            input=field, size=emb, name="ctr_field%d_emb" % i,
            param_attr=ParamAttr(name="ctr_field%d_emb.w0" % i,
                                 sparse_update=True)))
    h = L.fc(input=deep_feats, size=hidden[0], act=A.Relu(), name="ctr_h0")
    for j, width in enumerate(hidden[1:], start=1):
        h = L.fc(input=h, size=width, act=A.Relu(), name="ctr_h%d" % j)
    deep = L.fc(input=h, size=1, act=None, bias_attr=False, name="ctr_deep")

    logit = L.addto(input=[wide, deep], act=A.Sigmoid(), name="ctr_prob")
    label = L.data(name="click", type=data_type.dense_vector(1))
    cost = L.multi_binary_label_cross_entropy(input=logit, label=label,
                                              name="ctr_cost")
    return logit, label, cost
