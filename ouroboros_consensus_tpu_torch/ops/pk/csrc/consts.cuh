// Generated by ops/pk/build.py:render_consts() — do not edit.
#pragma once
#include <stdint.h>
#ifdef PK_HOST
#define PK_CONST static const
#else
#define PK_CONST __constant__ const
#endif
PK_CONST uint32_t PK_TWO_P[10] = {0x7ffffdau, 0x3fffffeu, 0x7fffffeu, 0x3fffffeu, 0x7fffffeu, 0x3fffffeu, 0x7fffffeu, 0x3fffffeu, 0x7fffffeu, 0x3fffffeu};
PK_CONST uint32_t PK_D[10] = {0x35978a3u, 0x0d37284u, 0x3156ebdu, 0x06a0a0eu, 0x001c029u, 0x179e898u, 0x3a03cbbu, 0x1ce7198u, 0x2e2b6ffu, 0x1480db3u};
PK_CONST uint32_t PK_D2[10] = {0x2b2f159u, 0x1a6e509u, 0x22add7au, 0x0d4141du, 0x0038052u, 0x0f3d130u, 0x3407977u, 0x19ce331u, 0x1c56dffu, 0x0901b67u};
PK_CONST uint32_t PK_SQRT_M1[10] = {0x20ea0b0u, 0x186c9d2u, 0x08f189du, 0x035697fu, 0x0bd0c60u, 0x1fbd7a7u, 0x2804c9eu, 0x1e16569u, 0x004fc1du, 0x0ae0c92u};
PK_CONST uint32_t PK_A[10] = {0x0076d06u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u};
PK_CONST uint32_t PK_NEG_A[10] = {0x3f892e7u, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu};
PK_CONST uint32_t PK_A2[10] = {0x0c21c24u, 0x0000dc9u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u, 0x0000000u};
PK_CONST uint32_t PK_C2A2[10] = {0x2f7cacdu, 0x1a0945bu, 0x3ffffccu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu, 0x3ffffffu, 0x1ffffffu};
PK_CONST uint32_t PK_SQRT_2I[10] = {0x1f15f3cu, 0x079362du, 0x370e762u, 0x1ca9680u, 0x342f39fu, 0x0042858u, 0x17fb361u, 0x01e9a96u, 0x3fb03e2u, 0x151f36du};
PK_CONST uint32_t PK_SQRT_M2I[10] = {0x1f15f3eu, 0x079362du, 0x370e762u, 0x1ca9680u, 0x342f39fu, 0x0042858u, 0x17fb361u, 0x01e9a96u, 0x3fb03e2u, 0x151f36du};
PK_CONST uint8_t PK_L_BYTES[32] = {237, 211, 245, 92, 26, 99, 18, 88, 214, 156, 247, 162, 222, 249, 222, 20, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 16};
PK_CONST uint64_t PK_SHA512_H0[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full, 0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
PK_CONST uint64_t PK_SHA512_K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full, 0xe9b5dba58189dbbcull,
    0x3956c25bf348b538ull, 0x59f111f1b605d019ull, 0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull,
    0xd807aa98a3030242ull, 0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull, 0xc19bf174cf692694ull,
    0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull, 0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull,
    0x2de92c6f592b0275ull, 0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full, 0xbf597fc7beef0ee4ull,
    0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull, 0x06ca6351e003826full, 0x142929670a0e6e70ull,
    0x27b70a8546d22ffcull, 0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull, 0x92722c851482353bull,
    0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull, 0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull,
    0xd192e819d6ef5218ull, 0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull, 0x34b0bcb5e19b48a8ull,
    0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull, 0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull,
    0x748f82ee5defb2fcull, 0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull, 0xc67178f2e372532bull,
    0xca273eceea26619cull, 0xd186b8c721c0c207ull, 0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull,
    0x06f067aa72176fbaull, 0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull, 0x431d67c49c100d4cull,
    0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull, 0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};
PK_CONST uint8_t PK_B2B_SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};
// the same rows as compile-time constants: index k in nibble 15 - k
#define PK_B2B_SIGMA_NIB0 0x0123456789abcdefull
#define PK_B2B_SIGMA_NIB1 0xea489fd61c02b753ull
#define PK_B2B_SIGMA_NIB2 0xb8c052fdae367194ull
#define PK_B2B_SIGMA_NIB3 0x7931dcbe265a40f8ull
#define PK_B2B_SIGMA_NIB4 0x905724afe1bc683dull
#define PK_B2B_SIGMA_NIB5 0x2c6a0b834d75fe19ull
#define PK_B2B_SIGMA_NIB6 0xc51fed4a0763928bull
#define PK_B2B_SIGMA_NIB7 0xdb7ec13950f4862aull
#define PK_B2B_SIGMA_NIB8 0x6fe9b308c2d714a5ull
#define PK_B2B_SIGMA_NIB9 0xa2847615fb9e3cd0ull
