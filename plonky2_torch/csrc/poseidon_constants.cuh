// Poseidon-Goldilocks round constants (device constant memory under nvcc,
// a host array otherwise) and the MDS layer's frequency-domain kernels.
// Generated by `python -m plonky2_torch.hash.poseidon_constants` from
// plonky2_torch/hash/poseidon_constants.py; do not edit.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define POSEIDON_CONSTANT __constant__
#define POSEIDON_HD __host__ __device__
#else
#define POSEIDON_CONSTANT static const
#define POSEIDON_HD
#endif

POSEIDON_CONSTANT uint64_t kRoundConstants[360] = {
    0xb585f766f2144405ull, 0x7746a55f43921ad7ull, 0xb2fb0d31cee799b4ull, 0x0f6760a4803427d7ull,
    0xe10d666650f4e012ull, 0x8cae14cb07d09bf1ull, 0xd438539c95f63e9full, 0xef781c7ce35b4c3dull,
    0xcdc4a239b0c44426ull, 0x277fa208bf337bffull, 0xe17653a29da578a1ull, 0xc54302f225db2c76ull,
    0x86287821f722c881ull, 0x59cd1a8a41c18e55ull, 0xc3b919ad495dc574ull, 0xa484c4c5ef6a0781ull,
    0x308bbd23dc5416ccull, 0x6e4a40c18f30c09cull, 0x9a2eedb70d8f8cfaull, 0xe360c6e0ae486f38ull,
    0xd5c7718fbfc647fbull, 0xc35eae071903ff0bull, 0x849c2656969c4be7ull, 0xc0572c8c08cbbbadull,
    0xe9fa634a21de0082ull, 0xf56f6d48959a600dull, 0xf7d713e806391165ull, 0x8297132b32825dafull,
    0xad6805e0e30b2c8aull, 0xac51d9f5fcf8535eull, 0x502ad7dc18c2ad87ull, 0x57a1550c110b3041ull,
    0x66bbd30e6ce0e583ull, 0x0da2abef589d644eull, 0xf061274fdb150d61ull, 0x28b8ec3ae9c29633ull,
    0x92a756e67e2b9413ull, 0x70e741ebfee96586ull, 0x019d5ee2af82ec1cull, 0x6f6f2ed772466352ull,
    0x7cf416cfe7e14ca1ull, 0x61df517b86a46439ull, 0x85dc499b11d77b75ull, 0x4b959b48b9c10733ull,
    0xe8be3e5da8043e57ull, 0xf5c0bc1de6da8699ull, 0x40b12cbf09ef74bfull, 0xa637093ecb2ad631ull,
    0x3cc3f892184df408ull, 0x2e479dc157bf31bbull, 0x6f49de07a6234346ull, 0x213ce7bede378d7bull,
    0x5b0431345d4dea83ull, 0xa2de45780344d6a1ull, 0x7103aaf94a7bf308ull, 0x5326fc0d97279301ull,
    0xa9ceb74fec024747ull, 0x27f8ec88bb21b1a3ull, 0xfceb4fda1ded0893ull, 0xfac6ff1346a41675ull,
    0x7131aa45268d7d8cull, 0x9351036095630f9full, 0xad535b24afc26bfbull, 0x4627f5c6993e44beull,
    0x645cf794b8f1cc58ull, 0x241c70ed0af61617ull, 0xacb8e076647905f1ull, 0x3737e9db4c4f474dull,
    0xe7ea5e33e75fffb6ull, 0x90dee49fc9bfc23aull, 0xd1b1edf76bc09c92ull, 0x0b65481ba645c602ull,
    0x99ad1aab0814283bull, 0x438a7c91d416ca4dull, 0xb60de3bcc5ea751cull, 0xc99cab6aef6f58bcull,
    0x69a5ed92a72ee4ffull, 0x5e7b329c1ed4ad71ull, 0x5fc0ac0800144885ull, 0x32db829239774ecaull,
    0x0ade699c5830f310ull, 0x7cc5583b10415f21ull, 0x85df9ed2e166d64full, 0x6604df4fee32bcb1ull,
    0xeb84f608da56ef48ull, 0xda608834c40e603dull, 0x8f97fe408061f183ull, 0xa93f485c96f37b89ull,
    0x6704e8ee8f18d563ull, 0xcee3e9ac1e072119ull, 0x510d0e65e2b470c1ull, 0xf6323f486b9038f0ull,
    0x0b508cdeffa5ceefull, 0xf2417089e4fb3cbdull, 0x60e75c2890d15730ull, 0xa6217d8bf660f29cull,
    0x7159cd30c3ac118eull, 0x839b4e8fafead540ull, 0x0d3f3e5e82920adcull, 0x8f7d83bddee7bba8ull,
    0x780f2243ea071d06ull, 0xeb915845f3de1634ull, 0xd19e120d26b6f386ull, 0x016ee53a7e5fecc6ull,
    0xcb5fd54e7933e477ull, 0xacb8417879fd449full, 0x9c22190be7f74732ull, 0x5d693c1ba3ba3621ull,
    0xdcef0797c2b69ec7ull, 0x3d639263da827b13ull, 0xe273fd971bc8d0e7ull, 0x418f02702d227ed5ull,
    0x8c25fda3b503038cull, 0x2cbaed4daec8c07cull, 0x5f58e6afcdd6ddc2ull, 0x284650ac5e1b0ebaull,
    0x635b337ee819dab5ull, 0x9f9a036ed4f2d49full, 0xb93e260cae5c170eull, 0xb0a7eae879ddb76dull,
    0xd0762cbc8ca6570cull, 0x34c6efb812b04bf5ull, 0x40bf0ab5fa14c112ull, 0xb6b570fc7c5740d3ull,
    0x5a27b9002de33454ull, 0xb1a5b165b6d2b2d2ull, 0x8722e0ace9d1be22ull, 0x788ee3b37e5680fbull,
    0x14a726661551e284ull, 0x98b7672f9ef3b419ull, 0xbb93ae776bb30e3aull, 0x28fd3b046380f850ull,
    0x30a4680593258387ull, 0x337dc00c61bd9ce1ull, 0xd5eca244c7a4ff1dull, 0x7762638264d279bdull,
    0xc1e434bedeefd767ull, 0x0299351a53b8ec22ull, 0xb2d456e4ad251b80ull, 0x3e9ed1fda49cea0bull,
    0x2972a92ba450bed8ull, 0x20216dd77be493deull, 0xadffe8cf28449ec6ull, 0x1c4dbb1c4c27d243ull,
    0x15a16a8a8322d458ull, 0x388a128b7fd9a609ull, 0x2300e5d6baedf0fbull, 0x2f63aa8647e15104ull,
    0xf1c36ce86ecec269ull, 0x27181125183970c9ull, 0xe584029370dca96dull, 0x4d9bbc3e02f1cfb2ull,
    0xea35bc29692af6f8ull, 0x18e21b4beabb4137ull, 0x1e3b9fc625b554f4ull, 0x25d64362697828fdull,
    0x5a3f1bb1c53a9645ull, 0xdb7f023869fb8d38ull, 0xb462065911d4e1fcull, 0x49c24ae4437d8030ull,
    0xd793862c112b0566ull, 0xaadd1106730d8febull, 0xc43b6e0e97b0d568ull, 0xe29024c18ee6fca2ull,
    0x5e50c27535b88c66ull, 0x10383f20a4ff9a87ull, 0x38e8ee9d71a45af8ull, 0xdd5118375bf1a9b9ull,
    0x775005982d74d7f7ull, 0x86ab99b4dde6c8b0ull, 0xb1204f603f51c080ull, 0xef61ac8470250ecfull,
    0x1bbcd90f132c603full, 0x0cd1dabd964db557ull, 0x11a3ae5beb9d1ec9ull, 0xf755bfeea585d11dull,
    0xa3b83250268ea4d7ull, 0x516306f4927c93afull, 0xddb4ac49c9efa1daull, 0x64bb6dec369d4418ull,
    0xf9cc95c22b4c1fccull, 0x08d37f755f4ae9f6ull, 0xeec49b613478675bull, 0xf143933aed25e0b0ull,
    0xe4c5dd8255dfc622ull, 0xe7ad7756f193198eull, 0x92c2318b87fff9cbull, 0x739c25f8fd73596dull,
    0x5636cac9f16dfed0ull, 0xdd8f909a938e0172ull, 0xc6401fe115063f5bull, 0x8ad97b33f1ac1455ull,
    0x0c49366bb25e8513ull, 0x0784d3d2f1698309ull, 0x530fb67ea1809a81ull, 0x410492299bb01f49ull,
    0x139542347424b9acull, 0x9cb0bd5ea1a1115eull, 0x02e3f615c38f49a1ull, 0x985d4f4a9c5291efull,
    0x775b9feafdcd26e7ull, 0x304265a6384f0f2dull, 0x593664c39773012cull, 0x4f0a2e5fb028f2ceull,
    0xdd611f1000c17442ull, 0xd8185f9adfea4fd0ull, 0xef87139ca9a3ab1eull, 0x3ba71336c34ee133ull,
    0x7d3a455d56b70238ull, 0x660d32e130182684ull, 0x297a863f48cd1f43ull, 0x90e0a736a751ebb7ull,
    0x549f80ce550c4fd3ull, 0x0f73b2922f38bd64ull, 0x16bf1f73fb7a9c3full, 0x6d1f5a59005bec17ull,
    0x02ff876fa5ef97c4ull, 0xc5cb72a2a51159b0ull, 0x8470f39d2d5c900eull, 0x25abb3f1d39fcb76ull,
    0x23eb8cc9b372442full, 0xd687ba55c64f6364ull, 0xda8d9e90fd8ff158ull, 0xe3cbdc7d2fe45ea7ull,
    0xb9a8c9b3aee52297ull, 0xc0d28a5c10960bd3ull, 0x45d7ac9b68f71a34ull, 0xeeb76e397069e804ull,
    0x3d06c8bd1514e2d9ull, 0x9c9c98207cb10767ull, 0x65700b51aedfb5efull, 0x911f451539869408ull,
    0x7ae6849fbc3a0ec6ull, 0x3bb340eba06afe7eull, 0xb46e9d8b682ea65eull, 0x8dcf22f9a3b34356ull,
    0x77bdaeda586257a7ull, 0xf19e400a5104d20dull, 0xc368a348e46d950full, 0x9ef1cd60e679f284ull,
    0xe89cd854d5d01d33ull, 0x5cd377dc8bb882a2ull, 0xa7b0fb7883eee860ull, 0x7684403ec392950dull,
    0x5fa3f06f4fed3b52ull, 0x8df57ac11bc04831ull, 0x2db01efa1e1e1897ull, 0x54846de4aadb9ca2ull,
    0xba6745385893c784ull, 0x541d496344d2c75bull, 0xe909678474e687feull, 0xdfe89923f6c9c2ffull,
    0xece5a71e0cfedc75ull, 0x5ff98fd5d51fe610ull, 0x83e8941918964615ull, 0x5922040b47f150c1ull,
    0xf97d750e3dd94521ull, 0x5080d4c2b86f56d7ull, 0xa7de115b56c78d70ull, 0x6a9242ac87538194ull,
    0xf7856ef7f9173e44ull, 0x2265fc92feb0dc09ull, 0x17dfc8e4f7ba8a57ull, 0x9001a64209f21db8ull,
    0x90004c1371b893c5ull, 0xb932b7cf752e5545ull, 0xa0b1df81b6fe59fcull, 0x8ef1dd26770af2c2ull,
    0x0541a4f9cfbeed35ull, 0x9e61106178bfc530ull, 0xb3767e80935d8af2ull, 0x0098d5782065af06ull,
    0x31d191cd5c1466c7ull, 0x410fefafa319ac9dull, 0xbdf8f242e316c4abull, 0x9e8cd55b57637ed0ull,
    0xde122bebe9a39368ull, 0x4d001fd58f002526ull, 0xca6637000eb4a9f8ull, 0x2f2339d624f91f78ull,
    0x6d1a7918c80df518ull, 0xdf9a4939342308e9ull, 0xebc2151ee6c8398cull, 0x03cc2ba8a1116515ull,
    0xd341d037e840cf83ull, 0x387cb5d25af4afccull, 0xbba2515f22909e87ull, 0x7248fe7705f38e47ull,
    0x4d61e56a525d225aull, 0x262e963c8da05d3dull, 0x59e89b094d220ec2ull, 0x055d5b52b78b9c5eull,
    0x82b27eb33514ef99ull, 0xd30094ca96b7ce7bull, 0xcf5cb381cd0a1535ull, 0xfeed4db6919e5a7cull,
    0x41703f53753be59full, 0x5eeea940fcde8b6full, 0x4cd1f1b175100206ull, 0x4a20358574454ec0ull,
    0x1478d361dbbf9facull, 0x6f02dc07d141875cull, 0x296a202ed8e556a2ull, 0x2afd67999bf32ee5ull,
    0x7acfd96efa95491dull, 0x6798ba0c0abb2c6dull, 0x34c6f57b26c92122ull, 0x5736e1bad206b5deull,
    0x20057d2a0056521bull, 0x3dea5bd5d0578bd7ull, 0x16e50d897d4634acull, 0x29bff3ecb9b7a6e3ull,
    0x475cd3205a3bdcdeull, 0x18a42105c31b7e88ull, 0x023e7414af663068ull, 0x15147108121967d7ull,
    0xe4a3dff1d7d6fef9ull, 0x01a8d1a588085737ull, 0x11b4c74eda62beefull, 0xe587cc0d69a73346ull,
    0x1ff7327017aa2a6eull, 0x594e29c42473d06bull, 0xf6f31db1899b12d5ull, 0xc02ac5e47312d3caull,
    0xe70201e960cb78b8ull, 0x6f90ff3b6a65f108ull, 0x42747a7245e7fa84ull, 0xd1f507e43ab749b2ull,
    0x1c86d265f15750cdull, 0x3996ce73dd832c1cull, 0x8e7fba02983224bdull, 0xba0dec7103255dd4ull,
    0x9e9cbd781628fc5bull, 0xdae8645996edd6a5ull, 0xdebe0853b1a1d378ull, 0xa49229d24d014343ull,
    0x7be5b9ffda905e1cull, 0xa3c95eaec244aa30ull, 0x0230bca8f4df0544ull, 0x4135c2bebfe148c6ull,
    0x166fc0cc438a3c72ull, 0x3762b59a8ae83efaull, 0xe8928a4c89114750ull, 0x2a440b51a4945ee5ull,
    0x80cefd2b7d99ff83ull, 0xbb9879c6e61fd62aull, 0x6e7c8f1a84265034ull, 0x164bb2de1bbeddc8ull,
    0xf3c12fe54d5c653bull, 0x40b9e922ed9771e2ull, 0x551f5b0fbe7b1840ull, 0x25032aa7c4cb1811ull,
    0xaaed34074b164346ull, 0x8ffd96bbf9c9c81dull, 0x70fc91eb5937085cull, 0x7f795e2a5f915440ull,
    0x4543d9df5476d3cbull, 0xf172d73e004fc90dull, 0xdfd1c4febcc81238ull, 0xbc8dfb627fe558fcull,
};

// 3-point kernels at DFT frequencies 0, 2 and 1 (real, imaginary), with
// the inverse DFT's 1/4 folded in; tap d multiplies input b - d.
POSEIDON_HD constexpr int64_t kMdsFreq0(int d) { return d == 0 ? 16 : d == 1 ? 32 : 16; }
POSEIDON_HD constexpr int64_t kMdsFreq2(int d) { return d == 0 ? -1 : d == 1 ? 8 : 2; }
POSEIDON_HD constexpr int64_t kMdsFreq1Re(int d) { return d == 0 ? 2 : d == 1 ? -1 : -16; }
POSEIDON_HD constexpr int64_t kMdsFreq1Im(int d) { return d == 0 ? 1 : d == 1 ? 4 : 1; }
constexpr uint64_t kMdsDiag0 = 8;
// For 32-bit halves every intermediate of the frequency-domain MDS, and
// each output with the diagonal added, is below 2^kMdsFreqBoundBits in
// magnitude (proved by the generator over all inputs).
constexpr int kMdsFreqBoundBits = 41;
